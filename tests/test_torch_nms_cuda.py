"""The CUDA NMS kernel (csrc/nms.cu) against the plain PyTorch version, on the card.

Needs a CUDA device and nvcc; skips elsewhere. Imports no JAX, so it runs on
a machine without it: `python -m pytest -m gpu tests/test_torch_nms_cuda.py`.
"""

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.ops import nms as torch_nms
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _fixture(rng, b, k, size=600.0, cluster=0.4, invalid=0.1):
    x1 = rng.uniform(0, size, (b, k))
    y1 = rng.uniform(0, size, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 200, (b, k)),
                      y1 + rng.uniform(1, 200, (b, k))], -1).astype(np.float32)
    centers = boxes[:, :32].copy()
    n = int(k * cluster)
    for i in range(b):
        idx = rng.choice(k, n, replace=False)
        boxes[i, idx] = centers[i, rng.randint(0, 32, n)] + rng.uniform(-4, 4, (n, 4))
    valid = rng.uniform(0, 1, (b, k)) >= invalid
    return boxes, valid


@pytest.mark.parametrize(
    "b,k,max_out,thr",
    [(1, 6000, 300, 0.7), (4, 6000, 300, 0.7), (20, 300, 50, 0.3), (1, 12000, 2000, 0.7), (3, 65, 70, 0.5),
     (2, 1, 1, 0.5), (4, 128, 1, 0.0)],
)
def test_kernel_matches_plain_version(cuda, b, k, max_out, thr):
    boxes, valid = _fixture(np.random.RandomState(k), b, k)
    tb, tv = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = NMS_KERNEL.launches
    got = torch_nms.nms_alive_sorted(tb, tv, thr, max_out)
    torch.cuda.synchronize()
    assert NMS_KERNEL.launches == before + 1
    ref = torch_nms.nms_alive_sorted_reference(tb, tv, thr, max_out)
    assert torch.equal(got, ref)
    assert not bool((got & ~tv).any())
    assert int(got.sum(-1).max()) <= max_out


def test_kernel_rejects_bad_inputs(cuda):
    boxes = torch.zeros(1, 8, 4, device=cuda)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        NMS_KERNEL(boxes.double(), valid, 0.5, 4)
    with pytest.raises(ValueError):
        NMS_KERNEL(boxes[:, ::2], valid[:, :4], 0.5, 4)
    with pytest.raises(ValueError):
        NMS_KERNEL(boxes, valid[:, :4], 0.5, 4)
