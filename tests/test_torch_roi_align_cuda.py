"""The CUDA fused-pyramid RoIAlign kernel (csrc/roi_align.cu) against the plain
PyTorch version, on the card.

Needs a CUDA device and nvcc; skips elsewhere. Imports no JAX, so it runs on
a machine without it: `python -m pytest -m gpu tests/test_torch_roi_align_cuda.py`.
Tolerance atol/rtol 1e-5: both round every sample coordinate and tent weight
alike (the kernel is built with -fmad=false); they differ in how the plain
version's matmuls add the bilinear terms.
"""

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.ops import roi_align as port
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
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, b, n, c, bucket, hw, elongated=False, invalid=0.0):
    """Planes of `bucket`, rois inside each image's extent `hw` [B, 2]."""
    planes = [rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c).astype(np.float32)
              for s in STRIDES]
    h, w = hw[:, :1], hw[:, 1:]
    x1 = rng.uniform(0, 1, (b, n)) * (w - 2)
    y1 = rng.uniform(0, 1, (b, n)) * (h - 2)
    x2 = np.minimum(x1 + rng.uniform(1, 400, (b, n)), w - 1)
    y2 = np.minimum(y1 + rng.uniform(1, 400, (b, n)), h - 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    for i, (hi, wi) in enumerate(hw):
        rois[i, 0] = [0, 0, wi - 1, hi - 1]  # the whole valid extent, on its edges
        rois[i, 1] = [wi - 5, hi - 3, wi - 1, hi - 1]  # its bottom-right corner
        if elongated:
            rois[i, 2] = [3, 7, min(wi - 1, 900), 27]  # aspect > 10
    wh = np.sqrt(np.maximum(rois[..., 2] - rois[..., 0], 0)
                 * np.maximum(rois[..., 3] - rois[..., 1], 0) + 1e-8)
    levels = np.clip(np.floor(4 + np.log2(wh / 224)), 2, 5).astype(np.int64) - 2
    valid = rng.uniform(size=(b, n)) >= invalid
    return planes, rois, levels, valid, hw.astype(np.float32)


def _run(cuda, planes, rois, levels, valid, hw, crop=14, misalign=False):
    """Kernel and plain version on the case; with `misalign`, every plane is a
    contiguous view 4 bytes past a 16-byte boundary (the scalar path)."""
    t = [torch.from_numpy(p).to(cuda) for p in planes]
    if misalign:
        t = [torch.cat([p.new_zeros(1), p.flatten()])[1:].view(p.shape) for p in t]
        assert not vectorizable(t, torch.empty(4, device=cuda))
    args = (t, *[torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in (rois, levels, valid, hw[:, 0], hw[:, 1])], crop, STRIDES)
    before = ROI_ALIGN_KERNEL.launches
    got = port.roi_align_multilevel(*args)
    torch.cuda.synchronize()
    assert ROI_ALIGN_KERNEL.launches == before + 1
    ref = port.roi_align_multilevel_reference(*args)
    return got, ref


@pytest.mark.parametrize("name,b,n,c,bucket,hw,elongated,invalid", [
    ("fixture", 2, 24, 16, (192, 256), [[180, 250], [150, 200]], False, 0.2),
    ("elongated_edges_invalid", 2, 16, 16, (640, 1024), [[600, 1000], [500, 380]], True, 0.3),
    ("served_b1", 1, 1000, 256, (640, 1024), [[600, 800]], True, 0.05),
    ("odd_channels", 1, 9, 40, (128, 128), [[100, 128]], False, 0.0),
    ("channels_not_multiple_of_4", 2, 33, 42, (192, 256), [[180, 250], [150, 200]], True, 0.1),
    ("three_channels", 1, 20, 3, (128, 128), [[100, 128]], False, 0.0),
    ("train_b1", 1, 256, 256, (640, 1024), [[600, 800]], True, 0.0),
    ("misaligned_planes", 1, 40, 64, (192, 256), [[180, 250]], True, 0.1),
])
def test_kernel_matches_plain_version(cuda, name, b, n, c, bucket, hw, elongated, invalid):
    rng = np.random.RandomState(n + c)
    case = _case(rng, b, n, c, bucket, np.asarray(hw), elongated, invalid)
    got, ref = _run(cuda, *case, misalign=name == "misaligned_planes")
    assert got.shape == (b, n, 14, 14, c)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    valid = torch.from_numpy(case[3]).to(cuda)
    assert not bool(got[~valid].any())
    assert bool((got[valid].abs().amax(dim=(1, 2, 3)) > 0).all())


@pytest.mark.parametrize("c", [256, 42])
def test_single_level_launches_match_plain_version(cuda, c):
    """K2: the kernel launched with one plane per level through
    `roi_align_single_level` (the per-level training path), summed over the
    levels, against the plain single-level version."""
    rng = np.random.RandomState(c)
    planes, rois, levels, valid, hw = _case(rng, 1, 256, c, (640, 1024), np.asarray([[600, 800]]),
                                            True, 0.05)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    r, ih, iw = to(rois), to(hw[:, 0]), to(hw[:, 1])
    got = ref = 0
    before = ROI_ALIGN_SINGLE_KERNEL.launches
    for k, s in enumerate(STRIDES):
        active = to((levels == k) & valid)
        got = got + port.roi_align_single_level(to(planes[k]), r, active, ih, iw, 14, s)
        ref = ref + port.roi_align_single_level_reference(to(planes[k]), r, active, ih, iw, 14, s)
    torch.cuda.synchronize()
    assert ROI_ALIGN_SINGLE_KERNEL.launches == before + len(STRIDES)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_bad_inputs(cuda):
    planes = [torch.zeros(1, 8, 8, 4, device=cuda), torch.zeros(1, 4, 4, 4, device=cuda)]
    rois = torch.zeros(1, 3, 4, device=cuda)
    levels = torch.zeros(1, 3, dtype=torch.long, device=cuda)
    valid = torch.ones(1, 3, dtype=torch.bool, device=cuda)
    ext = torch.full((1,), 30.0, device=cuda)
    with pytest.raises(TypeError):
        ROI_ALIGN_KERNEL([p.double() for p in planes], rois, levels, valid, ext, ext, 14, (4, 8))
    with pytest.raises(ValueError):
        ROI_ALIGN_KERNEL(planes, rois, levels, valid, ext, ext, 14, (4,))
    with pytest.raises(ValueError):
        ROI_ALIGN_KERNEL([planes[0][:, :, ::2], planes[1]], rois, levels, valid, ext, ext, 14,
                         (4, 8))
    with pytest.raises(ValueError):
        ROI_ALIGN_KERNEL(planes, rois.cpu(), levels, valid, ext, ext, 14, (4, 8))
