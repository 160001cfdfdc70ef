"""VGG16 Faster R-CNN on the card against the port's CPU path.

Needs a CUDA device and nvcc (every NMS runs the kernel K1); skips
elsewhere. Imports no JAX: `python -m pytest -m gpu tests/test_torch_vgg16_cuda.py`.
The CPU path is held against JAX by tests/test_torch_vgg16.py.

Both sides build the detector from one seed at a 128x128 bucket with
anchor scales (2, 4, 8) and small proposal and sample counts, the score
layers scaled as in the CPU tests so that random-weight scores separate,
and caffe-scaled pixels (N(0, 50)).

- `predict`, float32 (TF32 off): labels and validity equal, scores atol
  1e-4, boxes atol 1e-3 px; K1 launched twice (the RPN NMS and the
  class-batched NMS).
- One training loss and backward with the same sampler draws and dropout
  masks, float32 with cuDNN off (PyTorch's own CUDA GEMMs): losses rtol
  1e-4, counts equal, every gradient within 2e-3 of its tensor's largest
  value; K1 launched once.
- The same under bfloat16 compute, with the CPU step's training
  proposals given to both (bf16 noise in the RPN deltas may move a
  proposal across the RoI IoU threshold): losses rtol 2e-2, counts equal,
  every gradient's cosine with the CPU's > 0.9 and all together > 0.99
  (the bounds of tests/test_torch_bf16.py).
- A VGG16 checkpoint written on the card restores on the CPU, bit for bit.
"""

import shutil

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.training.checkpoints import CheckpointManager
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer

pytestmark = pytest.mark.gpu

POST_NMS, ROI_SAMPLES = 64, 32


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernel has no CPU or interpret mode)")


def _config(dtype="float32"):
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(scales=[2, 4, 8], rpn_proposal_train_pre_nms_sample_number=256,
               rpn_proposal_train_after_nms_sample_number=POST_NMS, rpn_total_sample_number=64,
               rpn_pos_sample_max_number=32, roi_total_sample_number=ROI_SAMPLES,
               roi_pos_sample_max_number=8, rpn_proposal_test_pre_nms_sample_number=256,
               rpn_proposal_test_after_nms_sample_number=32, max_objects_per_image=10,
               max_objects_per_class_per_image=10, tpu_image_buckets=[[128, 128]],
               image_min_size=128, image_max_size=128, tpu_max_gt_boxes=8,
               tpu_compute_dtype=dtype)
    return cfg


def _detector(device, dtype="float32", roi_scale=1.0):
    det = model_factory("faster_rcnn", "vgg16", _config(dtype), device=device, seed=1)
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
        det.roi_head.roi_head_score.weight.mul_(roi_scale)
    return det


def _batch():
    rng = np.random.RandomState(3)
    image = (rng.randn(1, 128, 128, 3) * 50.0).astype(np.float32)
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    return (image, np.asarray([[120, 124]], np.int32), gt, np.arange(8)[None] < 3,
            np.asarray([[3, 7, 12, 0, 0, 0, 0, 0]], np.int32))


def _draws(det):
    return TrainDraws.sample(torch.Generator().manual_seed(5), 1,
                             (128 // 16) ** 2 * det.num_anchors, POST_NMS, ROI_SAMPLES,
                             det.roi_dropout)


def _step(device, dtype="float32", pinned=None):
    """One loss and backward -> (metrics, gradients on the host, K1 launches)."""
    det = _detector(device, dtype)
    if pinned is not None:
        own = det._proposals

        def proposals(*args, **kwargs):
            if "rois" not in pinned:
                pinned["rois"] = tuple(t.cpu() for t in own(*args, **kwargs))
            return tuple(t.to(device) for t in pinned["rois"])

        det._proposals = proposals
    NMS_KERNEL.reset_launches()
    total, metrics = det.loss_fn(*_batch(), _draws(det).to(device))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in det.named_parameters() if p.requires_grad},
            NMS_KERNEL.launches)


def test_vgg16_predict_on_the_card_matches_the_cpu():
    image, hw = _batch()[0][0], _batch()[1][0]
    out = []
    for device in ("cuda", "cpu"):
        det = _detector(device, roi_scale=10.0)
        NMS_KERNEL.reset_launches()
        out.append(([t.cpu() for t in det.predict(image, hw)], NMS_KERNEL.launches))
    ((gb, gl, gs, gv), launches), ((cb, cl, cs, cv), cpu_launches) = out
    assert launches == 2 and cpu_launches == 0
    assert bool(cv.any())
    assert torch.equal(gv, cv) and torch.equal(gl, cl)
    np.testing.assert_allclose(gs.numpy(), cs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), cb.numpy(), rtol=0, atol=1e-3)


def test_vgg16_training_step_on_the_card_matches_the_cpu():
    cpu_m, cpu_g, _ = _step("cpu")
    torch.backends.cudnn.enabled = False
    try:
        cuda_m, cuda_g, launches = _step("cuda")
    finally:
        torch.backends.cudnn.enabled = True
    assert launches == 1
    assert cpu_m["num_rpn_fg"] > 0 and cpu_m["num_roi_fg"] > 0
    for k, v in cpu_m.items():
        if k.startswith("num_"):
            assert cuda_m[k] == v, k
        else:
            np.testing.assert_allclose(cuda_m[k], v, rtol=1e-4, err_msg=k)
    assert cuda_g.keys() == cpu_g.keys()
    for name, w in cpu_g.items():
        np.testing.assert_allclose(cuda_g[name].numpy(), w.numpy(), rtol=0,
                                   atol=2e-3 * float(w.abs().max()), err_msg=name)
    assert float(cpu_g["roi_head.fc1.weight"].abs().max()) > 0


def test_vgg16_bf16_step_on_the_card_against_the_cpu():
    pinned = {}
    cpu_m, cpu_g, _ = _step("cpu", "bfloat16", pinned)
    cuda_m, cuda_g, launches = _step("cuda", "bfloat16", pinned)
    assert launches == 0  # the proposals are pinned: the card ran no RPN NMS
    for k, v in cpu_m.items():
        tol = 2e-2 * abs(v) if k.endswith("loss") else 0.0
        assert abs(cuda_m[k] - v) <= tol, (k, cuda_m[k], v)
    every = []
    for name, w in cpu_g.items():
        a, b = cuda_g[name].double().flatten(), w.double().flatten()
        if not a.any() or not b.any():
            assert not a.any() and not b.any(), name
            continue
        assert float(a @ b / (a.norm() * b.norm())) > 0.9, name
        every.append((a, b))
    a, b = torch.cat([x for x, _ in every]), torch.cat([y for _, y in every])
    assert float(a @ b / (a.norm() * b.norm())) > 0.99


def test_vgg16_checkpoint_written_on_the_card_restores_on_the_cpu(tmp_path):
    det = model_factory("faster_rcnn", "vgg16", _config(), device="cuda", seed=1)
    opt = make_optimizer(det.cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for t in list(det.state_dict().values()) + list(opt.trace.values()):
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    opt.count = 9
    CheckpointManager(str(tmp_path)).save(det, opt)
    cpu = model_factory("faster_rcnn", "vgg16", _config(), device="cpu", seed=3)
    cpu_opt = make_optimizer(cpu.cfg, cpu)
    assert CheckpointManager(str(tmp_path)).restore(cpu, cpu_opt) == 9
    for k, v in det.state_dict().items():
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    for k, v in opt.trace.items():
        assert torch.equal(cpu_opt.trace[k], v.cpu()), k
    shutil.rmtree(tmp_path, ignore_errors=True)
