"""Checkpoint loading for the command-line tools (port of
`tf_eager_object_detection_tpu/ref_import/cli.py`).

- `add_import_flags(parser)`: the third-party checkpoint flags of the eval
  and infer tools.
- `load_checkpoint_params(detector, ckpt, args)` loads, in place, and
  returns the eval image format:
  - `--use_tf_faster_rcnn_model`: a tf-faster-rcnn TF checkpoint through
    the VGG16 or ResNet map of `name_maps` ("bgr");
  - `--use_fpn_tensorflow_model`: an FPN_Tensorflow TF checkpoint
    ("rgb": those models were trained on RGB input, and the reference
    evaluates them so, eval_pascal.py:226);
  - `--keras_h5`: a keras-applications `.h5` into the backbone (and, for
    ResNet Faster R-CNN, the conv5 RoI head) (None);
  - otherwise a directory of the port's `CheckpointManager` (its latest
    step) or a params `.npz` in the JAX package's `save_params` format
    (None).
  The importers write into the detector's current weights: its seeded
  init plays the part of JAX's `init()` for what a file does not cover.
- `load_backbone_weights(detector, path_or_url)`: the pretrained backbone
  of a fresh training run: a keras-applications `.h5` (a local path, an
  `https://` URL with an optional `#md5=<hex>`, or "keras" for the
  reference's release file of the detector's backbone, downloaded once
  into `~/.cache/tpu_od` and checked against its md5), or a slim `vgg_16`
  TF-Saver checkpoint prefix (VGG16 only, conv1_1's input channels
  reversed). A plain `http://` URL is refused.

TF checkpoints need tensorflow and `.h5` files h5py; where either is
missing its loader raises ImportError.
"""

from __future__ import annotations

import glob
import hashlib
import os
import warnings
from typing import Dict, Optional, Tuple

from tf_eager_object_detection_tpu_torch.ref_import import name_maps
from tf_eager_object_detection_tpu_torch.ref_import.importers import (
    apply_name_map,
    load_keras_h5,
    load_params_tree,
    load_tf_checkpoint_dict,
    params_tree,
)

__all__ = [
    "add_import_flags",
    "load_checkpoint_params",
    "load_backbone_weights",
    "KERAS_WEIGHT_URLS",
]

_IMPORT_FLAGS = ("use_tf_faster_rcnn_model", "use_fpn_tensorflow_model", "keras_h5")

# keras-applications release files the reference pulls by URL+hash
# (resnet_faster_rcnn.py:9-28: notop md5 is WEIGHTS_HASHES[name][1];
# vgg16_faster_rcnn.py:348-355).
_KERAS_RESNET_BASE = (
    "https://github.com/keras-team/keras-applications/releases/download/resnet/"
)
_KERAS_VGG_BASE = (
    "https://github.com/fchollet/deep-learning-models/releases/download/v0.1/"
)
KERAS_WEIGHT_URLS: Dict[str, Tuple[str, str]] = {
    "vgg16": (
        _KERAS_VGG_BASE + "vgg16_weights_tf_dim_ordering_tf_kernels.h5",
        "64373286793e3c8b2b4e3219cbf3544b",
    ),
    "resnet50": (
        _KERAS_RESNET_BASE + "resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5",
        "4d473c1dd8becc155b73f8504c6f6626",
    ),
    "resnet101": (
        _KERAS_RESNET_BASE + "resnet101_weights_tf_dim_ordering_tf_kernels_notop.h5",
        "88cf7a10940856eca736dc7b7e228a21",
    ),
    "resnet152": (
        _KERAS_RESNET_BASE + "resnet152_weights_tf_dim_ordering_tf_kernels_notop.h5",
        "ee4c566cf9a93f14d82f913c2dc6dd0c",
    ),
}


def add_import_flags(parser):
    parser.add_argument("--use_tf_faster_rcnn_model", action="store_true",
                        help="CKPT is a tf-faster-rcnn TF checkpoint (vgg16/resnet backbones; "
                             "needs tensorflow)")
    parser.add_argument("--use_fpn_tensorflow_model", action="store_true",
                        help="CKPT is an FPN_Tensorflow TF checkpoint (resnet backbones; "
                             "evaluates with RGB input like the reference; needs tensorflow)")
    parser.add_argument("--keras_h5", action="store_true",
                        help="CKPT is a keras-applications .h5 file (backbone weights only; "
                             "detection heads stay at init; needs h5py)")
    return parser


def _keras_modules(detector) -> Tuple[str, ...]:
    """Modules the keras-applications file covers. For resnet C4 Faster R-CNN
    the conv5 stack lives in the RoI head and the reference loads it from the
    same notop file (resnet_faster_rcnn.py:161-185)."""
    if detector.model_type == "faster_rcnn" and detector.backbone_name.startswith("resnet"):
        return ("extractor", "roi_head")
    return ("extractor",)


def _backbone_depth(backbone: str) -> int:
    return int(backbone.replace("resnet", ""))


def load_checkpoint_params(detector, ckpt: str, args=None) -> Optional[str]:
    """Load `ckpt` into `detector` as the flags of `args` say -> the eval
    image format (None: the preprocessing's own channel order)."""
    from tf_eager_object_detection_tpu_torch.training.checkpoints import (
        CheckpointManager,
        load_params,
    )

    if sum(bool(getattr(args, f, False)) for f in _IMPORT_FLAGS) > 1:
        raise ValueError("pass at most one third-party-checkpoint flag")

    if getattr(args, "use_tf_faster_rcnn_model", False):
        if detector.model_type != "faster_rcnn":
            raise ValueError("--use_tf_faster_rcnn_model needs --model_type faster_rcnn")
        if detector.backbone_name == "vgg16":
            name_map = name_maps.vgg16_tf_faster_rcnn_map()
        else:
            name_map = name_maps.resnet_tf_faster_rcnn_map(
                _backbone_depth(detector.backbone_name))
        tensors = load_tf_checkpoint_dict(ckpt)
        load_params_tree(detector, apply_name_map(params_tree(detector), tensors, name_map))
        return "bgr"

    if getattr(args, "use_fpn_tensorflow_model", False):
        if detector.model_type != "fpn":
            raise ValueError("--use_fpn_tensorflow_model needs --model_type fpn")
        name_map = name_maps.fpn_tensorflow_map(_backbone_depth(detector.backbone_name))
        tensors = load_tf_checkpoint_dict(ckpt)
        load_params_tree(detector, apply_name_map(params_tree(detector), tensors, name_map))
        return "rgb"

    if getattr(args, "keras_h5", False):
        load_params_tree(detector,
                         load_keras_h5(params_tree(detector), ckpt, _keras_modules(detector)))
        return None

    if ckpt.endswith(".npz") and os.path.isfile(ckpt):
        load_params(ckpt, detector)
        return None
    if os.path.isdir(ckpt):
        if CheckpointManager(ckpt).restore(detector) is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {ckpt!r} (pass the training --logs_dir or a "
                "params .npz)")
        return None
    raise FileNotFoundError(
        f"{ckpt!r} is neither a checkpoint directory of the port nor a params .npz; pass "
        "--use_tf_faster_rcnn_model, --use_fpn_tensorflow_model or --keras_h5 for a "
        "third-party checkpoint")


def _cache_path(url: str) -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_od", os.path.basename(url))


def _download(url: str, dest: str, md5: Optional[str] = "") -> str:
    """`tf.keras.utils.get_file` analogue: fetch once, verify md5 if known."""
    import urllib.request

    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if not os.path.exists(dest):
        urllib.request.urlretrieve(url, dest)  # noqa: S310 - https release URL
    if md5:
        with open(dest, "rb") as f:
            digest = hashlib.md5(f.read()).hexdigest()
        if digest != md5:
            raise ValueError(f"{dest}: md5 {digest} != expected {md5}")
    return dest


def _is_tf_checkpoint(path: str) -> bool:
    """TF-Saver checkpoints are a `<path>.index` + `<path>.data-*` family
    (the `path` itself is a prefix, not a file)."""
    return os.path.exists(path + ".index") or bool(glob.glob(path + ".data-0000*"))


def load_backbone_weights(detector, path_or_url: str) -> None:
    """Fresh-training pretrained-backbone load, in place (see the module's
    docstring for what `path_or_url` may be)."""
    if _is_tf_checkpoint(path_or_url):
        if detector.backbone_name != "vgg16":
            raise ValueError(
                "slim TF-checkpoint backbone init is the reference's vgg16 "
                f"path (vgg16_faster_rcnn.py:357-390); got {detector.backbone_name}"
            )
        tensors = load_tf_checkpoint_dict(path_or_url)
        load_params_tree(detector, apply_name_map(
            params_tree(detector), tensors, name_maps.vgg16_slim_backbone_map(),
            bgr_flip_layers=(("extractor", "block1_conv1"),)))
        return

    path = path_or_url
    if path_or_url == "keras":
        url, md5 = KERAS_WEIGHT_URLS[detector.backbone_name]
        path = _download(url, _cache_path(url), md5)
    elif path_or_url.startswith("http://"):
        raise ValueError(
            "refusing plain-http backbone weights URL (no transport "
            "integrity): use https://, or append '#md5=<hex>' to pin a "
            "digest, or download manually and pass a local path"
        )
    elif path_or_url.startswith("https://"):
        # optional '#md5=<hex>' fragment pins a digest for arbitrary URLs
        url, _, frag = path_or_url.partition("#")
        md5 = frag[len("md5="):] if frag.startswith("md5=") else None
        if md5 is None:
            warnings.warn(
                f"downloading backbone weights from {url} WITHOUT checksum "
                "verification; append '#md5=<hex>' to the URL to verify",
                stacklevel=2,
            )
        path = _download(url, _cache_path(url), md5)
    load_params_tree(detector,
                     load_keras_h5(params_tree(detector), path, _keras_modules(detector)))
