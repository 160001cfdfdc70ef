"""The port's `Trainer` and checkpoints on the card against the CPU.

Needs a CUDA device and nvcc (the step runs the NMS kernel K1); skips
elsewhere. Imports no JAX, so it runs on a machine without it:
`python -m pytest -m gpu tests/test_torch_trainer_cuda.py`.

- One `Trainer` step of Faster R-CNN ResNet-50 (C4) on the card equals the
  same step with `device="cpu"`: same seed, batch (a procedural rehearsal
  tree's JPEG TFRecords through `dataset_factory`) and draws, at the tiny
  config of tests/test_torch_trainer.py. With cuDNN off, as in
  tests/test_torch_fpn_train.py's card check: losses rtol 1e-4, counts
  equal, each parameter's change within 2e-3 of its tensor's largest
  change.
- A checkpoint written on the card restores on the CPU, bit for bit.
- Adam (`optimizer_type='adam'`): one `make_train_step(..., with_probe=True)`
  step on the card (cuDNN off) against the CPU at the tiny config, same
  seed, batch and draws: losses rtol 1e-4, counts equal, `probe` within
  1e-5 * sum |p|, the update within 1e-3 * lr where the CPU's |g| exceeds
  2e-3 of its tensor's largest (below that the two gradients may differ in
  sign, tests/test_torch_adam_debug.py) and within 2 * lr everywhere, the
  moments within 1e-2 of their tensor's largest; and an Adam checkpoint
  written on the card restores on the CPU, bit for bit.
"""

import shutil

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import generate
from tf_eager_object_detection_tpu_torch.training.checkpoints import CheckpointManager
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

pytestmark = pytest.mark.gpu

POST_NMS, ROI_SAMPLES = 64, 32


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernel has no CPU or interpret mode)")


@pytest.fixture
def tmp_path(tmp_path):
    """Checkpoints of a full ResNet-50 go as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_config():
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(scales=[2, 4, 8], rpn_proposal_train_pre_nms_sample_number=256,
               rpn_proposal_train_after_nms_sample_number=POST_NMS, rpn_total_sample_number=64,
               rpn_pos_sample_max_number=32, roi_total_sample_number=ROI_SAMPLES,
               roi_pos_sample_max_number=8, tpu_image_buckets=[[128, 128]], image_min_size=128,
               image_max_size=128, tpu_max_gt_boxes=16)
    return cfg


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    generate(str(root / "VOCdevkit" / "VOC2007"), n_train=4, n_test=20, seed=0)
    return create_pascal_tf_records(str(root / "VOCdevkit"), "2007", "trainval",
                                    str(root / "tfrecords"), num_shards=2)


def _one_step(device, records, logs):
    det = model_factory("faster_rcnn", "resnet50", tiny_config(), device=device)
    draws = TrainDraws.sample(torch.Generator().manual_seed(3), 1,
                              (128 // 16) ** 2 * det.num_anchors, POST_NMS, ROI_SAMPLES)
    trainer = Trainer(det, logs, logging_every_n_steps=1000, seed=5,
                      draws=lambda step: draws.to(device))
    before = {n: p.detach().cpu().clone() for n, p in det.named_parameters()}
    metrics = []
    step_fn = trainer.step_fn

    def recording(batch, d):
        out = step_fn(batch, d)
        metrics.append({k: float(v) for k, v in out.items()})
        return out

    trainer.step_fn = recording
    batches = dataset_factory("pascal", "train", {"model_config": tiny_config(),
                                                  "tf_records_list": records, "batch_size": 1,
                                                  "seed": 5, "preprocessing_type": "tf"})
    trainer.train(batches, 1, 1)
    return metrics[0], before, {n: p.detach().cpu() for n, p in det.named_parameters()}


def test_trainer_step_on_the_card_matches_the_cpu(records, tmp_path):
    cpu_m, cpu_before, cpu_after = _one_step("cpu", records, str(tmp_path / "cpu"))
    torch.backends.cudnn.enabled = False
    try:
        cuda_m, _, cuda_after = _one_step("cuda", records, str(tmp_path / "cuda"))
    finally:
        torch.backends.cudnn.enabled = True
    assert set(cuda_m) == set(cpu_m)
    assert all(np.isfinite(v) for v in cpu_m.values()) and cpu_m["num_rpn_fg"] > 0
    for k, v in cpu_m.items():
        if k.startswith("num_"):
            assert cuda_m[k] == v, k
        else:
            np.testing.assert_allclose(cuda_m[k], v, rtol=1e-4, err_msg=k)
    for name, after in cpu_after.items():
        change = after - cpu_before[name]
        np.testing.assert_allclose((cuda_after[name] - cpu_before[name]).numpy(), change.numpy(),
                                   rtol=0, atol=2e-3 * change.abs().max().item(), err_msg=name)


def test_checkpoint_written_on_the_card_restores_on_the_cpu(tmp_path):
    det = model_factory("faster_rcnn", "resnet50", config_factory("pascal", "faster_rcnn"),
                        device="cuda", seed=1)
    opt = make_optimizer(det.cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for t in list(det.state_dict().values()) + list(opt.trace.values()):
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    opt.count = 17
    CheckpointManager(str(tmp_path)).save(det, opt)
    cpu = model_factory("faster_rcnn", "resnet50", config_factory("pascal", "faster_rcnn"),
                        device="cpu", seed=3)
    cpu_opt = make_optimizer(cpu.cfg, cpu)
    assert CheckpointManager(str(tmp_path)).restore(cpu, cpu_opt) == 17
    assert cpu_opt.count == 17
    for k, v in det.state_dict().items():
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    for k, v in opt.trace.items():
        assert torch.equal(cpu_opt.trace[k], v.cpu()), k


def _adam_step(device):
    cfg = dict(tiny_config(), optimizer_type="adam")
    det = model_factory("faster_rcnn", "resnet50", cfg, device=device, seed=1)
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)  # random-weight proposals separate
    opt = make_optimizer(cfg, det)
    draws = TrainDraws.sample(torch.Generator().manual_seed(3), 1,
                              (128 // 16) ** 2 * det.num_anchors, POST_NMS, ROI_SAMPLES)
    rng = np.random.RandomState(3)
    gt = np.zeros((1, 16, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    batch = (rng.randn(1, 128, 128, 3).astype(np.float32), np.array([[120, 124]]), gt,
             np.arange(16)[None] < 3, np.array([[3, 7, 12] + [0] * 13]))
    before = {n: p.detach().cpu().clone() for n, p in det.named_parameters()}
    metrics = make_train_step(det, opt, with_probe=True)(batch, draws.to(device))
    return dict(
        metrics={k: float(v) for k, v in metrics.items()}, lr=opt.schedule(0), before=before,
        after={n: p.detach().cpu() for n, p in det.named_parameters()},
        grads={n: p.grad.cpu() for n, p in det.named_parameters() if p.grad is not None},
        abs_sum=float(sum(t.abs().double().sum() for t in det.state_dict().values())),
        moments={s: {n: t.cpu() for n, t in getattr(opt, s).items()} for s in ("mu", "nu")})


def test_adam_step_on_the_card_matches_the_cpu():
    cpu = _adam_step("cpu")
    torch.backends.cudnn.enabled = False
    try:
        cuda = _adam_step("cuda")
    finally:
        torch.backends.cudnn.enabled = True
    assert cpu["metrics"]["num_rpn_fg"] > 0 and "probe" in cpu["metrics"]
    for k, v in cpu["metrics"].items():
        if k.startswith("num_"):
            assert cuda["metrics"][k] == v, k
        elif k == "probe":
            assert abs(cuda["metrics"][k] - v) <= 1e-5 * cpu["abs_sum"]
        else:
            np.testing.assert_allclose(cuda["metrics"][k], v, rtol=1e-4, err_msg=k)
    lr = cpu["lr"]
    for name, g in cpu["grads"].items():
        diff = ((cuda["after"][name] - cpu["before"][name])
                - (cpu["after"][name] - cpu["before"][name])).abs()
        sure = g.abs() > 2e-3 * g.abs().max()
        assert float(diff.max()) <= 2 * lr, name
        if sure.any():
            assert float(diff[sure].max()) <= 1e-3 * lr, (name, float(diff[sure].max()) / lr)
    for slot, tensors in cpu["moments"].items():
        for name, t in tensors.items():
            np.testing.assert_allclose(cuda["moments"][slot][name].numpy(), t.numpy(), rtol=0,
                                       atol=1e-2 * t.abs().max().item(), err_msg=f"{slot} {name}")


def test_adam_checkpoint_written_on_the_card_restores_on_the_cpu(tmp_path):
    cfg = dict(config_factory("pascal", "faster_rcnn"), optimizer_type="adam")
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=1)
    opt = make_optimizer(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for t in [*det.state_dict().values(), *opt.mu.values(), *opt.nu.values()]:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    opt.count = 9
    CheckpointManager(str(tmp_path)).save(det, opt)
    cpu = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=3)
    cpu_opt = make_optimizer(cfg, cpu)
    assert CheckpointManager(str(tmp_path)).restore(cpu, cpu_opt) == 9 == cpu_opt.count
    for k, v in det.state_dict().items():
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    for slot in ("mu", "nu"):
        for k, v in getattr(opt, slot).items():
            assert torch.equal(getattr(cpu_opt, slot)[k], v.cpu()), (slot, k)
