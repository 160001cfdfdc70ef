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


def _disjoint(b, k):
    """A grid of 10x10 boxes 20 px apart: no pair overlaps."""
    p = np.arange(k)
    one = np.stack([(p % 50) * 20.0, (p // 50) * 20.0, (p % 50) * 20.0 + 10,
                    (p // 50) * 20.0 + 10], -1).astype(np.float32)
    return np.repeat(one[None], b, 0), np.ones((b, k), bool)


def _edge_case(name):
    """(boxes, valid, thr, max_output) of the word-blocked scan's edge cases."""
    rng = np.random.RandomState(len(name))
    if name == "cap_mid_word":
        return (*_fixture(rng, 1, 300), 0.5, 37)
    if name == "cap_at_word_boundary":  # the 128th kept box is the last of word 1
        return (*_disjoint(1, 256), 0.5, 128)
    if name == "k_not_word_multiple":
        return (*_fixture(rng, 2, 201), 0.6, 150)
    if name == "k_one":
        return (*_fixture(rng, 1, 1, invalid=0.0), 0.5, 1)
    if name == "all_invalid":
        boxes, valid = _fixture(rng, 1, 130)
        return boxes, np.zeros_like(valid), 0.5, 20
    if name == "all_identical":  # one kept: every later copy overlaps it
        boxes = np.repeat(np.asarray([[[40, 50, 140, 170]]], np.float32), 200, 1)
        return boxes, np.ones((1, 200), bool), 0.7, 50
    if name == "no_overlaps_cap_early":
        return (*_disjoint(1, 500), 0.3, 100)
    if name == "no_overlaps_cap_beyond_k":  # every word resolved, no OR work
        return (*_disjoint(3, 700), 0.3, 1000)
    if name == "per_class_b20":
        return (*_fixture(rng, 20, 300, invalid=0.2), 0.3, 50)
    if name.startswith("threshold_ties"):  # integer boxes: many IoUs exactly at thr
        lo = rng.randint(0, 8, (2, 500, 2))
        boxes = np.concatenate([lo, lo + rng.randint(1, 5, (2, 500, 2))], -1).astype(np.float32)
        thr = {"half": 0.5, "third": 1.0 / 3.0, "0.7": 0.7}[name.rsplit("_", 1)[1]]
        return boxes, np.ones((2, 500), bool), thr, 300
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cap_mid_word", "cap_at_word_boundary", "k_not_word_multiple",
                                  "k_one", "all_invalid", "all_identical",
                                  "no_overlaps_cap_early", "no_overlaps_cap_beyond_k",
                                  "per_class_b20", "threshold_ties_half", "threshold_ties_third",
                                  "threshold_ties_0.7"])
def test_kernel_matches_plain_version_on_edge_cases(cuda, name):
    boxes, valid, thr, max_out = _edge_case(name)
    tb, tv = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    got = NMS_KERNEL(tb, tv, thr, max_out)
    torch.cuda.synchronize()
    ref = torch_nms.nms_alive_sorted_reference(tb, tv, thr, max_out)
    assert torch.equal(got, ref)
    expect_kept = {"all_invalid": 0, "all_identical": 1, "cap_at_word_boundary": 128,
                   "no_overlaps_cap_early": 100, "no_overlaps_cap_beyond_k": 700, "k_one": 1}
    if name in expect_kept:
        assert got.sum(-1).tolist() == [expect_kept[name]] * boxes.shape[0]


def test_kernel_rejects_bad_inputs(cuda):
    boxes = torch.zeros(1, 8, 4, device=cuda)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        NMS_KERNEL(boxes.double(), valid, 0.5, 4)
    with pytest.raises(ValueError):
        NMS_KERNEL(boxes[:, ::2], valid[:, :4], 0.5, 4)
    with pytest.raises(ValueError):
        NMS_KERNEL(boxes, valid[:, :4], 0.5, 4)
