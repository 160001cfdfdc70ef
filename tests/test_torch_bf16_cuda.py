"""The RoIAlign kernels on bfloat16 planes (csrc/roi_align.cu's bf16 variant,
csrc/roi_align_backward.cu into float32 accumulators rounded to bf16) and a
bf16 training step, on the card.

Needs a CUDA device and nvcc; skips elsewhere. Imports no JAX:
`python -m pytest -m gpu tests/test_torch_bf16_cuda.py`.

- K4 / K2 on bf16 planes are bit-equal to the same kernels on
  `plane.float()` (a bf16 value widens to float32 exactly and the taps
  blend in the float32 kernel's order), on the 16-byte path (8 channels a
  unit), at C = 42 and on planes 2 bytes off a 16-byte boundary (the scalar
  path), and their launches count under "bfloat16".
- K5 / K3 for bf16 planes return the float32 accumulators rounded to bf16,
  and the accumulators are within 1e-5 of sum |g * w| of the plain
  backward (float atomics add in no fixed order; see
  tests/test_torch_roi_align_backward_cuda.py).
- An FPN bf16 training step at 128x128 on the card goes through the bf16
  variants of K4 / K5 and leaves the parameters and traces float32.
"""

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
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
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

pytestmark = pytest.mark.gpu

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(cuda, b, n, c, bucket, hws, seed=0, invalid=0.1, misalign=False):
    """bf16 planes of `bucket` (N(0, 1) rounded), rois inside each image's
    extent with the FPN level rule; with `misalign`, every plane a
    contiguous view 2 bytes past a 16-byte boundary."""
    rng = np.random.RandomState(seed)
    planes = [torch.from_numpy(rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c)
                               .astype(np.float32)).to(cuda).bfloat16() for s in STRIDES]
    if misalign:
        planes = [torch.cat([p.new_zeros(1), p.flatten()])[1:].view(p.shape) for p in planes]
    hws = np.asarray(hws, np.float32)
    h, w = hws[:, :1], hws[:, 1:]
    x1, y1 = rng.uniform(0, 1, (b, n)) * (w - 2), rng.uniform(0, 1, (b, n)) * (h - 2)
    side = np.exp(rng.uniform(np.log(2), np.log(500), (b, n, 2)))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(np.float32)
    rois[:, 0] = np.concatenate([np.zeros((b, 2)), w - 1, h - 1], -1)  # the whole extent
    wh = np.sqrt(np.maximum(rois[..., 2] - rois[..., 0], 0)
                 * np.maximum(rois[..., 3] - rois[..., 1], 0) + 1e-8)
    levels = np.clip(np.floor(4 + np.log2(wh / 224)), 2, 5).astype(np.int64) - 2
    valid = rng.uniform(size=(b, n)) >= invalid
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    return (planes, to(rois), to(levels), to(valid), to(hws[:, 0]), to(hws[:, 1]), 14, STRIDES)


CASES = [  # name, B, N, C, bucket, image extents, misaligned
    ("served_b4", 4, 1000, 256, (640, 1024), [[600, 800], [600, 1000], [576, 768], [640, 853]],
     False),
    ("train_b1", 1, 256, 256, (640, 1024), [[600, 800]], False),
    ("channels_42", 2, 64, 42, (192, 256), [[180, 250], [150, 200]], False),
    ("channels_12", 2, 64, 12, (192, 256), [[180, 250], [150, 200]], False),
    ("misaligned_planes", 2, 64, 64, (192, 256), [[180, 250], [150, 200]], True),
]


@pytest.mark.parametrize("name,b,n,c,bucket,hws,misalign", CASES)
def test_k4_on_bf16_planes_is_bit_equal_to_float32_planes(cuda, name, b, n, c, bucket, hws,
                                                          misalign):
    args = _case(cuda, b, n, c, bucket, hws, seed=n + c, misalign=misalign)
    planes = args[0]
    before = dict(ROI_ALIGN_KERNEL.launches_by_dtype)
    got = port.roi_align_multilevel(*args)
    want = ROI_ALIGN_KERNEL([p.float() for p in planes], *args[1:])
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert vectorizable(planes, got) == (c % 8 == 0 and not misalign)
    assert ROI_ALIGN_KERNEL.launches_by_dtype["bfloat16"] == before.get("bfloat16", 0) + 1
    torch.testing.assert_close(got, port.roi_align_multilevel_reference(*args), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", [256, 42])
def test_k2_on_bf16_planes_is_bit_equal_to_float32_planes(cuda, c):
    planes, rois, levels, valid, ih, iw, crop, strides = _case(
        cuda, 1, 256, c, (640, 1024), [[600, 800]], seed=c)
    before = ROI_ALIGN_SINGLE_KERNEL.launches_by_dtype.get("bfloat16", 0)
    for k, s in enumerate(strides):
        active = (levels == k) & valid
        got = port.roi_align_single_level(planes[k], rois, active, ih, iw, crop, s)
        want = port.roi_align_single_level(planes[k].float(), rois, active, ih, iw, crop, s)
        assert torch.equal(got, want)
    assert ROI_ALIGN_SINGLE_KERNEL.launches_by_dtype["bfloat16"] == before + len(strides)


def _plain_backward(g, args):
    planes, *rest = args
    return port.roi_align_multilevel_reference_backward(g, [p.float() for p in planes], *rest)


@pytest.mark.parametrize("name,b,n,c,bucket,hws,misalign", CASES[1:])
def test_k5_bf16_planes_are_the_rounded_accumulators(cuda, name, b, n, c, bucket, hws, misalign):
    args = _case(cuda, b, n, c, bucket, hws, seed=n + c + 1, misalign=misalign)
    g = torch.randn(b, n, 14, 14, c, generator=torch.Generator().manual_seed(c)).to(cuda)
    shapes = [tuple(p.shape) for p in args[0]]
    before = ROI_ALIGN_BACKWARD_KERNEL.launches_by_dtype.get("bfloat16", 0)
    planes16, acc = ROI_ALIGN_BACKWARD_KERNEL.accumulate(g, shapes, *args[1:], torch.bfloat16)
    torch.cuda.synchronize()
    assert ROI_ALIGN_BACKWARD_KERNEL.launches_by_dtype["bfloat16"] == before + 1
    assert [d.dtype for d in planes16] == [torch.bfloat16] * 4
    assert [d.dtype for d in acc] == [torch.float32] * 4
    assert all(torch.equal(d, a.bfloat16()) for d, a in zip(planes16, acc))
    ref, scale = _plain_backward(g, args), _plain_backward(g.abs(), args)
    for a, r, m in zip(acc, ref, scale):
        assert bool(((a - r).abs() <= 1e-5 * m).all())
    # through the autograd Function: the planes' gradients come back in bf16
    leaves = [p.detach().clone().requires_grad_() for p in args[0]]
    out = port.roi_align_multilevel(leaves, *args[1:])
    grads = torch.autograd.grad(out, leaves, g)
    assert [d.dtype for d in grads] == [torch.bfloat16] * 4
    # an accumulator within 1e-5 * m of r, rounded once to bf16 (by at most
    # 2**-8 of itself): within 1e-5 * m * (1 + 2**-8) + 2**-8 * |r| of r
    eps = 2.0 ** -8
    for d, r, m in zip(grads, ref, scale):
        assert bool(((d.float() - r).abs() <= 1e-5 * m * (1 + eps) + eps * r.abs()).all())


def test_k3_bf16_plane_is_the_rounded_accumulator(cuda):
    planes, rois, levels, valid, ih, iw, crop, strides = _case(
        cuda, 1, 256, 256, (640, 1024), [[600, 800]], seed=3)
    g = torch.randn(1, 256, 14, 14, 256, generator=torch.Generator().manual_seed(3)).to(cuda)
    for k, s in enumerate(strides):
        active = (levels == k) & valid
        (d16,), (acc,) = ROI_ALIGN_SINGLE_BACKWARD_KERNEL.accumulate(
            g, [tuple(planes[k].shape)], rois, torch.zeros_like(levels), active, ih, iw, crop,
            (s,), torch.bfloat16)
        assert d16.dtype == torch.bfloat16 and torch.equal(d16, acc.bfloat16())


def test_kernels_refuse_mixed_plane_dtypes(cuda):
    args = _case(cuda, 1, 8, 16, (64, 64), [[60, 60]])
    planes = [args[0][0].float(), *args[0][1:]]
    with pytest.raises(TypeError, match="dtypes"):
        ROI_ALIGN_KERNEL(planes, *args[1:])
    g = torch.zeros(1, 8, 14, 14, 16, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        ROI_ALIGN_BACKWARD_KERNEL(g, [tuple(p.shape) for p in planes], *args[1:], torch.float16)


def test_bf16_fpn_training_step_goes_through_the_bf16_kernels(cuda):
    cfg = dict(config_factory("pascal", "fpn"))
    cfg.update(tpu_compute_dtype="bfloat16", tpu_image_buckets=[[128, 128]], image_min_size=128,
               image_max_size=128, rpn_proposal_train_pre_nms_sample_number=512,
               rpn_proposal_train_after_nms_sample_number=64, rpn_total_sample_number=64,
               roi_total_sample_number=32, tpu_max_gt_boxes=8)
    det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=1)
    opt = make_optimizer(cfg, det)
    rng = np.random.RandomState(0)
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :2] = [[10, 12, 60, 70], [40, 30, 118, 100]]
    batch = (rng.randn(1, 128, 128, 3).astype(np.float32), np.asarray([[120, 124]]), gt,
             np.arange(8)[None] < 2, np.asarray([[3, 7, 0, 0, 0, 0, 0, 0]]))
    k4 = ROI_ALIGN_KERNEL.launches_by_dtype.get("bfloat16", 0)
    k5 = ROI_ALIGN_BACKWARD_KERNEL.launches_by_dtype.get("bfloat16", 0)
    metrics = make_train_step(det, opt)(batch, torch.Generator(device="cuda").manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert ROI_ALIGN_KERNEL.launches_by_dtype["bfloat16"] == k4 + 1
    assert ROI_ALIGN_BACKWARD_KERNEL.launches_by_dtype["bfloat16"] == k5 + 1
    assert {p.dtype for p in det.parameters()} == {torch.float32}
    assert {t.dtype for t in opt.trace.values()} == {torch.float32}
