"""The port's config presets and eval preprocessing against the JAX package's."""

import numpy as np
import pytest

from tf_eager_object_detection_tpu.config import config_factory as jax_config
from tf_eager_object_detection_tpu.data import preprocessing as jax_pre
from tf_eager_object_detection_tpu_torch.config import config_factory as torch_config
from tf_eager_object_detection_tpu_torch.data import preprocessing as torch_pre

# keys of the JAX presets that only select TPU code paths
_TPU_ONLY_KEYS = {"tpu_roi_align_contract", "tpu_fused_optimizer", "tpu_native_decode"}


@pytest.mark.parametrize("data_type", ["pascal", "coco"])
def test_faster_rcnn_presets_match(data_type):
    ours = torch_config.config_factory(data_type, "faster_rcnn")
    ref = jax_config.config_factory(data_type, "faster_rcnn")
    assert set(ref) - set(ours) == _TPU_ONLY_KEYS
    assert ours == {k: v for k, v in ref.items() if k in ours}


def test_config_factory_refuses_what_is_not_ported():
    """What the JAX factory has no preset for, the port refuses alike."""
    for data_type, model_type in [("coco", "fpn"), ("imagenet", "faster_rcnn"), ("pascal", "ssd")]:
        with pytest.raises(ValueError):
            jax_config.config_factory(data_type, model_type)
        with pytest.raises(ValueError):
            torch_config.config_factory(data_type, model_type)


def _image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


# VOC-like landscape and portrait, an image already at the bucket's scale, and
# one that the max-size rule limits
_SIZES = [(375, 500), (500, 333), (600, 1000), (200, 800)]
_MODES = [("caffe", None), ("caffe", "rgb"), ("tf", None), ("tf", "bgr")]


@pytest.mark.parametrize("use_cv2", [True, False], ids=["cv2", "numpy_resize"])
@pytest.mark.parametrize("preprocessing_type,image_format", _MODES)
def test_preprocess_eval_image_matches(monkeypatch, use_cv2, preprocessing_type, image_format):
    """Exact: the same numpy (or cv2) operations in the same order."""
    if use_cv2 and jax_pre.cv2 is None:
        pytest.skip("cv2 is not installed; the numpy resize case covers the port")
    if not use_cv2:
        monkeypatch.setattr(jax_pre, "cv2", None)
        monkeypatch.setattr(torch_pre, "cv2", None)
    cfg = torch_config.config_factory("pascal", "faster_rcnn")
    for i, (h, w) in enumerate(_SIZES):
        img = _image(h, w, i)
        got = torch_pre.preprocess_eval_image(img, cfg, preprocessing_type, image_format)
        ref = jax_pre.preprocess_eval_image(img, cfg, preprocessing_type, image_format)
        assert got[0].dtype == ref[0].dtype and got[0].shape == ref[0].shape
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2:] == ref[2:]


def test_bucket_choice_and_overflow_match():
    buckets = [[608, 1008], [1008, 608]]
    for hw in [(600, 800), (800, 600), (608, 608), (1200, 1200)]:
        assert torch_pre.pick_bucket(*hw, buckets) == jax_pre.pick_bucket(*hw, buckets)
    with pytest.raises(ValueError, match="exceeds bucket"):
        torch_pre.pad_to_bucket(np.zeros((700, 700, 3), np.float32), (608, 1008))
