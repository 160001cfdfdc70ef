"""The COCO shapes on the card: K1 at the 80-class post-processing shape and
Faster R-CNN `predict` with the COCO config, against the port's CPU path.

Needs a CUDA device and nvcc; skips elsewhere. Imports no JAX:
`python -m pytest -m gpu tests/test_torch_coco_cuda.py`. The CPU path is
held against JAX by tests/test_torch_coco_model.py.

- K1 at [80, 300] -> 100 @0.3 (one NMS over the 80 foreground classes of
  `post_ops_prediction` and `eval_post_process`), index-exact against the
  plain version: once with clustered boxes where most rows reach the cap,
  once with few valid slots where no row reaches it.
- C4 ResNet-50 with `config_factory("coco", "faster_rcnn")` at a 128x128
  bucket, anchor scales (1, 2, 4, 8) (12 anchors a cell), 81 classes, caps
  of 100, float32 (TF32 off): `predict` on the card against the CPU with
  labels and validity equal, scores atol 1e-4, boxes atol 1e-3 px; K1
  launched twice (the RPN NMS and the class-batched NMS at [80, 50] -> 100).
"""

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as torch_nms
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernel has no CPU or interpret mode)")


def _boxes(rng, b, k, cluster, invalid):
    """Score-sorted boxes on an 800x600 image: a share of jittered copies of a
    few centers, and a share of invalid slots."""
    x1, y1 = rng.uniform(0, 800, (b, k)), rng.uniform(0, 600, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, 300, (b, k)),
                      y1 + rng.uniform(8, 300, (b, k))], -1).astype(np.float32)
    n = int(k * cluster)
    for i in range(b):
        idx = rng.choice(k, n, replace=False)
        boxes[i, idx] = boxes[i, rng.randint(0, 16, n)] + rng.uniform(-5, 5, (n, 4))
    return boxes, rng.uniform(0, 1, (b, k)) >= invalid


@pytest.mark.parametrize("cluster,invalid,capped", [(0.3, 0.1, True), (0.4, 0.7, False)])
def test_k1_at_the_80_class_shape_matches_plain_version(cluster, invalid, capped):
    boxes, valid = _boxes(np.random.RandomState(80), 80, 300, cluster, invalid)
    tb, tv = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    NMS_KERNEL.reset_launches()
    got = torch_nms.nms_alive_sorted(tb, tv, 0.3, 100)
    torch.cuda.synchronize()
    assert NMS_KERNEL.launches == 1
    assert torch.equal(got, torch_nms.nms_alive_sorted_reference(tb, tv, 0.3, 100))
    kept = got.sum(-1)
    assert int(kept.max()) <= 100 and not bool((got & ~tv).any())
    at_cap = float((kept == 100).float().mean())
    assert at_cap > 0.5 if capped else at_cap == 0.0


def _config():
    cfg = dict(config_factory("coco", "faster_rcnn"))
    cfg.update(scales=[1, 2, 4, 8], rpn_proposal_test_pre_nms_sample_number=256,
               rpn_proposal_test_after_nms_sample_number=50, tpu_image_buckets=[[128, 128]],
               image_min_size=128, image_max_size=128)
    return cfg


def test_coco_predict_on_the_card_matches_the_cpu():
    image = np.random.RandomState(1).randn(128, 128, 3).astype(np.float32)
    hw = np.asarray([120, 124], np.int32)
    out = []
    for device in ("cuda", "cpu"):
        det = model_factory("faster_rcnn", "resnet50", _config(), device=device, seed=1)
        assert det.num_anchors == 12 and det.num_classes == 81
        with torch.no_grad():
            det.rpn_head.rpn_score_conv.weight.mul_(5.0)
            det.roi_head.roi_head_score.weight.mul_(10.0)
        NMS_KERNEL.reset_launches()
        out.append(([t.cpu() for t in det.predict(image, hw)], NMS_KERNEL.launches))
    ((gb, gl, gs, gv), launches), ((cb, cl, cs, cv), cpu_launches) = out
    assert launches == 2 and cpu_launches == 0
    assert gb.shape == (100, 4) and bool(cv.any())
    assert torch.equal(gv, cv) and torch.equal(gl, cl)
    np.testing.assert_allclose(gs.numpy(), cs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), cb.numpy(), rtol=0, atol=1e-3)
