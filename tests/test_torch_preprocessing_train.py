"""The port's training preprocessing against the JAX package's, on the CPU.

`preprocess_train_image` with the same image, boxes, labels and
`np.random.RandomState` seed through both: the same numpy (or cv2)
operations in the same order, so every output is exact, and both leave the
RandomState in the same place. Cases: augment on and off, caffe and tf,
cv2 and the numpy resize, landscape / portrait / more boxes than
`tpu_max_gt_boxes` / no box.
"""

import numpy as np
import pytest

from tf_eager_object_detection_tpu.data import preprocessing as jax_pre
from tf_eager_object_detection_tpu_torch.config import config_factory
from tf_eager_object_detection_tpu_torch.data import preprocessing as torch_pre

# (raw h, w, number of gt boxes)
_IMAGES = [(375, 500, 3), (500, 333, 1), (300, 400, 120), (400, 300, 0)]


def _item(h, w, n, seed):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    lo = rng.uniform(0.0, 0.7, (n, 2))
    hi = np.minimum(lo + rng.uniform(0.05, 0.5, (n, 2)), 1.0)
    boxes = np.concatenate([lo, hi], 1).astype(np.float32)
    return image, boxes, rng.randint(1, 21, n).astype(np.int32)


@pytest.mark.parametrize("use_cv2", [True, False], ids=["cv2", "numpy_resize"])
@pytest.mark.parametrize("preprocessing_type", ["caffe", "tf"])
@pytest.mark.parametrize("augment", [True, False], ids=["augment", "no_augment"])
def test_preprocess_train_image_matches(monkeypatch, use_cv2, preprocessing_type, augment):
    if use_cv2 and jax_pre.cv2 is None:
        pytest.skip("cv2 is not installed; the numpy resize case covers the port")
    if not use_cv2:
        monkeypatch.setattr(jax_pre, "cv2", None)
        monkeypatch.setattr(torch_pre, "cv2", None)
    cfg = config_factory.config_factory("pascal", "fpn")
    flips = 0
    for i, (h, w, n) in enumerate(_IMAGES):
        image, boxes, labels = _item(h, w, n, i)
        rng_port, rng_jax = np.random.RandomState(i), np.random.RandomState(i)
        got = torch_pre.preprocess_train_image(image, boxes, labels, cfg, rng_port,
                                               augment=augment,
                                               preprocessing_type=preprocessing_type)
        ref = jax_pre.preprocess_train_image(image, boxes, labels, cfg, rng_jax, augment=augment,
                                             preprocessing_type=preprocessing_type)
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        assert rng_port.rand() == rng_jax.rand()
        assert got[3].sum() == min(n, cfg["tpu_max_gt_boxes"])
        flips += augment and np.random.RandomState(i).rand() < 0.5
    assert (flips > 0) == augment  # the seeds flip some images when augmenting


def test_random_hflip_matches_and_mirrors_boxes():
    image, boxes, _ = _item(60, 80, 5, 3)
    for seed in range(6):
        got = torch_pre.random_hflip(image, boxes, np.random.RandomState(seed))
        ref = jax_pre.random_hflip(image, boxes, np.random.RandomState(seed))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        if got[0] is not image:  # flipped: x1' = 1 - x2, x2' = 1 - x1, y unchanged
            np.testing.assert_array_equal(got[0], image[:, ::-1])
            np.testing.assert_allclose(got[1][:, [1, 3]], 1.0 - boxes[:, [3, 1]])
            np.testing.assert_array_equal(got[1][:, [0, 2]], boxes[:, [0, 2]])
