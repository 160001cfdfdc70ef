"""The port's checkpoint importers against the JAX package's, on the CPU.

Each test writes a synthetic file in the real third-party format to
`tmp_path`, with the helpers of tests/test_ref_import_real_format.py
(keras-applications `.h5` in the new nested layout for ResNet-50 and the
old `{layer}_W_1:0` layout for VGG16; TF-Saver `.index` / `.data`
checkpoints of tf-faster-rcnn VGG16 and ResNet-50 and of FPN_Tensorflow
ResNet-50, slim convs without biases). The port's `load_checkpoint_params`
(or `load_backbone_weights`) loads it into a port detector whose weights
were first moved away from the seeded init (every entry + 7.5, so a bias
left at its start differs from a zero-filled one); JAX's loads it through
its own CLI functions from the same start: a stand-in detector whose
`init_params` returns the port's weights as the flax tree. The port's
whole state_dict must then be bit-equal to `state_dict_from_jax` of JAX's
result, and the image formats ("bgr", "rgb", None) equal. That the port's
flax-layout tree is JAX's real one (paths and shapes) is shown once, with
`jax.eval_shape` of the JAX `init_params`, for C4 ResNet-50, FPN ResNet-50
and VGG16.

VGG16's RoI head is cut to a 3x3x512 input (`vgg16_roi_feature_size`), so
slim's fc6 is [3, 3, 512, 4096] here ([7, 7, 512, 4096] at full size,
which `chip_smoke.py` imports on the card): the same reshape, at a size
this machine's memory takes in every test worker.

Also: the name maps equal JAX's; `apply_name_map`'s strict / missing
tensor semantics; a failed import leaves the detector as it was; the
`--backbone_weights` dispatch (slim prefix with the BGR flip on the input
channels, `.h5`, `https` with and without `#md5=`, `keras`, `http://`
refused), with the download cache under a temporary HOME and
`urllib.request.urlretrieve` replaced by a function that fails, so that
nothing reaches the network; `Trainer(backbone_weights=)` and a restored
checkpoint's precedence over it; `.pth` -> pickle.
"""

import argparse
import hashlib
import os
import shutil
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tf_eager_object_detection_tpu.config.config_factory import config_factory as jax_config
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.ref_import import cli as jax_cli
from tf_eager_object_detection_tpu.ref_import import importers as jax_importers
from tf_eager_object_detection_tpu.ref_import import name_maps as jax_maps
from tf_eager_object_detection_tpu.ref_import import pytorch_convert as jax_convert
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import import cli, importers, name_maps
from tf_eager_object_detection_tpu_torch.ref_import import pytorch_convert
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import state_dict_from_jax
from tf_eager_object_detection_tpu_torch.scripts import train as train_cli
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

from test_ref_import_real_format import (
    _fill_for,
    _slim_resnet_conv_entries,
    _write_saver_ckpt,
    keras_resnet_layer_names,
    keras_vgg16_layer_names,
    slim_vgg16_var_names,
)

VGG_ROI_INPUT = [3, 3, 512]
RESNET_HEADS = [
    ("resnet_v1_50/rpn_conv/3x3/", "rpn_first_conv"),
    ("resnet_v1_50/rpn_cls_score/", "rpn_score_conv"),
    ("resnet_v1_50/rpn_bbox_pred/", "rpn_bbox_conv"),
    ("resnet_v1_50/cls_score/", "roi_head_score"),
    ("resnet_v1_50/bbox_pred/", "roi_head_bboxes"),
]
FPN_HEADS = [
    ("build_rpn/rpn_conv/3x3/", "rpn_first_conv"),
    ("build_rpn/rpn_cls_score/", "rpn_score_conv"),
    ("build_rpn/rpn_bbox_pred/", "rpn_bbox_conv"),
    ("Fast-RCNN/build_fc_layers/fc1/", "fc1"),
    ("Fast-RCNN/build_fc_layers/fc2/", "fc2"),
    ("Fast-RCNN/cls_fc/", "roi_head_score"),
    ("Fast-RCNN/reg_fc/", "roi_head_bboxes"),
    ("build_pyramid/build_P5/", "build_p5"),
    ("build_pyramid/build_P4/reduce_dim_P4/", "build_p4_reduce_dims"),
    ("build_pyramid/fuse_P4/", "build_p4"),
    ("build_pyramid/build_P3/reduce_dim_P3/", "build_p3_reduce_dims"),
    ("build_pyramid/fuse_P3/", "build_p3"),
    ("build_pyramid/build_P2/reduce_dim_P2/", "build_p2_reduce_dims"),
    ("build_pyramid/fuse_P2/", "build_p2"),
]
VGG_HEADS = {  # tf-faster-rcnn VGG16 head prefix -> (layer, the checkpoint's own shape)
    "vgg_16/rpn_conv/3x3/": ("rpn_first_conv", None),
    "vgg_16/rpn_cls_score/": ("rpn_score_conv", None),
    "vgg_16/rpn_bbox_pred/": ("rpn_bbox_conv", None),
    "vgg_16/fc6/": ("fc1", (*VGG_ROI_INPUT, 4096)),  # slim stores fc6 / fc7 as convs
    "vgg_16/fc7/": ("fc2", (1, 1, 4096, 4096)),
    "vgg_16/cls_score/": ("roi_head_score", None),
    "vgg_16/bbox_pred/": ("roi_head_bboxes", None),
}


# ------------------------------------------------------------------ helpers
@pytest.fixture
def tmp_path(tmp_path):
    """A test's checkpoint files (up to a few hundred MB) go as soon as it ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _config(model_type, backbone):
    cfg = dict(config_factory("pascal", model_type))
    if backbone == "vgg16":
        cfg["vgg16_roi_feature_size"] = VGG_ROI_INPUT
    return cfg


def _moved_detector(model_type="faster_rcnn", backbone="resnet50"):
    """A port detector on the CPU with every weight moved off its init."""
    det = model_factory(model_type, backbone, _config(model_type, backbone), device="cpu")
    with torch.no_grad():
        for t in det.state_dict().values():
            t.add_(7.5)
    return det


def _jax_stand_in(det):
    """What JAX's CLI functions read of a detector, its `init_params`
    returning the port's current weights as the flax tree (the same start)."""
    tree = importers.params_tree(det)
    return types.SimpleNamespace(model_type=det.model_type, backbone=det.backbone_name,
                                 init_params=lambda key: tree), tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_state_equals_jax(det, jax_tree):
    want = state_dict_from_jax(_flat(jax_tree))
    got = det.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def _args(*flags):
    return cli.add_import_flags(argparse.ArgumentParser()).parse_args(list(flags))


def _layer_shape(tree, layer, leaf):
    for module in tree.values():
        if layer in module and leaf in module[layer]:
            return module[layer][leaf].shape
    raise AssertionError(f"no layer {layer!r} with a {leaf!r}")


def _slim_resnet_values(tree, conv_entries, head_entries):
    """A slim checkpoint's tensors: conv weights without biases and their
    BatchNorm 4-tuples, head weights and biases."""
    values = {}
    for prefix, layer in conv_entries:
        values[prefix + "weights"] = _fill_for(prefix + "weights",
                                               _layer_shape(tree, layer, "kernel"))
        bn = layer[: -len("_conv")] + "_bn"
        for leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
            values[prefix + "BatchNorm/" + leaf] = _fill_for(prefix + leaf,
                                                            _layer_shape(tree, bn, leaf))
    for prefix, layer in head_entries:
        values[prefix + "weights"] = _fill_for(prefix + "weights",
                                               _layer_shape(tree, layer, "kernel"))
        values[prefix + "biases"] = _fill_for(prefix + "biases",
                                              _layer_shape(tree, layer, "bias"))
    return values


def _slim_vgg16_values(tree):
    values = {}
    for name in slim_vgg16_var_names():
        block, idx = int(name.split("/")[2][4]), int(name.split("/")[2][6])
        leaf = "kernel" if name.endswith("weights") else "bias"
        values[name] = _fill_for(name, _layer_shape(tree, f"block{block}_conv{idx}", leaf))
    return values


# ------------------------------------------------------- the trees and maps
@pytest.mark.parametrize("model_type,backbone", [("faster_rcnn", "resnet50"),
                                                 ("fpn", "resnet50"),
                                                 ("faster_rcnn", "vgg16")])
def test_port_tree_is_jax_init_tree(model_type, backbone):
    """The tree the port's importers fill has the paths and shapes of JAX's
    `init_params` tree (stock config), so a name map addresses the same
    leaf in both."""
    jdet = jax_factory(model_type, backbone, dict(jax_config("pascal", model_type)))
    want = flatten_dict(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)), sep="/")
    det = model_factory(model_type, backbone, dict(config_factory("pascal", model_type)),
                        device="cpu")
    got = _flat(importers.params_tree(det))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())


def test_name_maps_equal_jax():
    assert name_maps.RESNET_STACK_BLOCKS == jax_maps.RESNET_STACK_BLOCKS
    assert name_maps.vgg16_slim_backbone_map() == jax_maps.vgg16_slim_backbone_map()
    assert name_maps.vgg16_tf_faster_rcnn_map() == jax_maps.vgg16_tf_faster_rcnn_map()
    for depth in (50, 101, 152):
        assert name_maps.resnet_tf_faster_rcnn_map(depth) == \
            jax_maps.resnet_tf_faster_rcnn_map(depth)
        assert name_maps.fpn_tensorflow_map(depth) == jax_maps.fpn_tensorflow_map(depth)


def test_apply_name_map_semantics_match_jax():
    """strict raises on a layer the tree lacks, non-strict skips it; a
    tensor the checkpoint lacks raises; a missing bias fills with zeros; the
    BGR flip reverses the HWIO kernel's input channels; a tensor of another
    shape and the same size is reshaped (fc6)."""
    rng = np.random.RandomState(0)
    tree = {"extractor": {"block1_conv1": {"kernel": rng.randn(3, 3, 3, 4).astype(np.float32),
                                           "bias": np.ones(4, np.float32)},
                          "conv1_bn": {k: rng.randn(4).astype(np.float32)
                                       for k in ("gamma", "beta", "moving_mean",
                                                 "moving_variance")}},
            "roi_head": {"fc1": {"kernel": np.zeros((2 * 2 * 3, 5), np.float32),
                                 "bias": np.ones(5, np.float32)}}}
    tensors = {"a/weights": rng.randn(3, 3, 3, 4).astype(np.float32),
               "fc/weights": rng.randn(2, 2, 3, 5).astype(np.float32),
               "fc/biases": rng.randn(5).astype(np.float32),
               **{f"bn/{k}": rng.randn(4).astype(np.float32)
                  for k in ("gamma", "beta", "moving_mean", "moving_variance")}}
    name_map = {"a/": ("extractor", "block1_conv1"), "bn/": ("extractor", "conv1_bn"),
                "fc/": ("roi_head", "fc1")}
    flip = (("extractor", "block1_conv1"),)
    got = importers.apply_name_map(tree, tensors, name_map, bgr_flip_layers=flip)
    want = jax_importers.apply_name_map(tree, tensors, name_map, bgr_flip_layers=flip)
    assert _flat(got).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
    np.testing.assert_array_equal(got["extractor"]["block1_conv1"]["kernel"],
                                  tensors["a/weights"][:, :, ::-1, :])
    assert not got["extractor"]["block1_conv1"]["bias"].any()
    assert tree["extractor"]["block1_conv1"]["bias"].all()  # the input tree is not touched
    for mod in (importers, jax_importers):
        with pytest.raises(KeyError, match="no layer"):
            mod.apply_name_map(tree, tensors, {"x/": ("extractor", "absent")})
        skipped = mod.apply_name_map(tree, tensors, {"x/": ("extractor", "absent")},
                                     strict=False)
        assert _flat(skipped).keys() == _flat(tree).keys()
        with pytest.raises(KeyError, match="missing b/weights"):
            mod.apply_name_map(tree, tensors, {"b/": ("extractor", "block1_conv1")})
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.apply_name_map(tree, {"a/weights": np.zeros((3, 3, 4, 4))},
                               {"a/": ("extractor", "block1_conv1")})


# -------------------------------------------------------------- keras .h5
def _write_keras_resnet_h5(h5py, path, tree):
    """keras-applications' new layout: layer group -> same-name subgroup ->
    kernel:0 / bias:0 or the BatchNorm 4-tuple (the JAX test's writer)."""
    names = keras_resnet_layer_names()
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names], dtype="S")
        for name in names:
            sub = f.create_group(name).create_group(name)
            leaves = (("gamma", "beta", "moving_mean", "moving_variance")
                      if name.endswith("_bn") else ("kernel", "bias"))
            for leaf in leaves:
                sub.create_dataset(f"{leaf}:0",
                                   data=_fill_for(f"{name}/{leaf}", _layer_shape(tree, name, leaf)))


def _write_keras_vgg16_h5(h5py, path, tree):
    """The old VGG16 layout: `{layer}_W_1:0` / `{layer}_b_1:0` in the layer group."""
    with h5py.File(path, "w") as f:
        for name in keras_vgg16_layer_names():
            g = f.create_group(name)
            g.create_dataset(f"{name}_W_1:0",
                             data=_fill_for(name + "/W", _layer_shape(tree, name, "kernel")))
            g.create_dataset(f"{name}_b_1:0",
                             data=_fill_for(name + "/b", _layer_shape(tree, name, "bias")))


@pytest.mark.parametrize("backbone", ["resnet50", "vgg16"])
def test_keras_h5_matches_jax(tmp_path, backbone):
    """`--keras_h5`: the extractor (and C4's conv5 RoI head) from the file,
    every other layer untouched, format None."""
    h5py = pytest.importorskip("h5py")
    det = _moved_detector("faster_rcnn", backbone)
    stand_in, start = _jax_stand_in(det)
    path = str(tmp_path / f"{backbone}.h5")
    (_write_keras_resnet_h5 if backbone == "resnet50" else _write_keras_vgg16_h5)(
        h5py, path, start)
    want, want_fmt = jax_cli.load_checkpoint_params(stand_in, path, _args("--keras_h5"))
    assert cli.load_checkpoint_params(det, path, _args("--keras_h5")) is want_fmt is None
    _assert_state_equals_jax(det, want)
    heads = ("rpn_head",) if backbone == "resnet50" else ("rpn_head", "roi_head")
    for k, v in _flat(start).items():
        if k.split("/")[0] in heads:
            np.testing.assert_array_equal(_flat(want)[k], v, err_msg=k)
    first = "conv1_conv" if backbone == "resnet50" else "block1_conv1"
    assert not np.array_equal(_flat(want)[f"extractor/{first}/kernel"],
                              _flat(start)[f"extractor/{first}/kernel"])
    if backbone == "resnet50":  # conv5 lives in the C4 RoI head
        assert not np.array_equal(_flat(want)["roi_head/conv5_block3_3_conv/kernel"],
                                  _flat(start)["roi_head/conv5_block3_3_conv/kernel"])


# ------------------------------------------------------- TF-Saver checkpoints
def _tf_case(model_type, backbone, tree):
    """(checkpoint values, flag, the flag's format) of a real-format
    tf-faster-rcnn or FPN_Tensorflow checkpoint over `tree`."""
    if backbone == "vgg16":
        values = _slim_vgg16_values(tree)
        for prefix, (layer, own_shape) in VGG_HEADS.items():
            values[prefix + "weights"] = _fill_for(
                prefix + "weights", own_shape or _layer_shape(tree, layer, "kernel"))
            values[prefix + "biases"] = _fill_for(prefix + "biases",
                                                  _layer_shape(tree, layer, "bias"))
        return values, "--use_tf_faster_rcnn_model", "bgr"
    if model_type == "faster_rcnn":
        return (_slim_resnet_values(tree, _slim_resnet_conv_entries(50), RESNET_HEADS),
                "--use_tf_faster_rcnn_model", "bgr")
    return (_slim_resnet_values(tree, _slim_resnet_conv_entries(50), FPN_HEADS),
            "--use_fpn_tensorflow_model", "rgb")


@pytest.mark.parametrize("model_type,backbone", [("faster_rcnn", "vgg16"),
                                                 ("faster_rcnn", "resnet50"),
                                                 ("fpn", "resnet50")])
def test_tf_checkpoint_matches_jax(tmp_path, model_type, backbone):
    """`--use_tf_faster_rcnn_model` (VGG16, ResNet-50) and
    `--use_fpn_tensorflow_model` (ResNet-50) on a Saver-written checkpoint:
    the whole state_dict bit-equal to JAX's import, slim conv biases zero,
    VGG16's fc6 / fc7 convs reshaped into the dense layers, and the format."""
    tf = pytest.importorskip("tensorflow")
    det = _moved_detector(model_type, backbone)
    stand_in, start = _jax_stand_in(det)
    values, flag, fmt = _tf_case(model_type, backbone, start)
    ckpt = _write_saver_ckpt(tf, tmp_path, values, "model.ckpt")
    want, want_fmt = jax_cli.load_checkpoint_params(stand_in, ckpt, _args(flag))
    assert cli.load_checkpoint_params(det, ckpt, _args(flag)) == want_fmt == fmt
    _assert_state_equals_jax(det, want)
    sd = det.state_dict()
    if backbone == "vgg16":
        fc6 = values["vgg_16/fc6/weights"].reshape(-1, 4096)
        assert torch.equal(sd["roi_head.fc1.weight"], torch.from_numpy(fc6.T.copy()))
        assert torch.equal(sd["roi_head.fc2.weight"],
                           torch.from_numpy(values["vgg_16/fc7/weights"][0, 0].T.copy()))
    else:
        conv5 = "roi_head" if model_type == "faster_rcnn" else "extractor"
        assert not sd[f"{conv5}.conv5_block3_3_conv.bias"].any()  # zero-filled, not + 7.5
        assert not sd["extractor.conv1_conv.bias"].any()
        np.testing.assert_array_equal(
            sd["extractor.conv1_bn.moving_variance"].numpy(),
            values["resnet_v1_50/conv1/BatchNorm/moving_variance"])


def test_failed_import_leaves_the_detector_untouched(tmp_path):
    """A checkpoint that lacks a mapped tensor raises KeyError, and an `.h5`
    dataset of the wrong size ValueError, before any weight changes."""
    h5py = pytest.importorskip("h5py")
    det = _moved_detector("faster_rcnn", "resnet50")
    before = {k: v.clone() for k, v in det.state_dict().items()}
    tree = importers.params_tree(det)
    values, _, _ = _tf_case("faster_rcnn", "resnet50", tree)
    del values["resnet_v1_50/block4/unit_3/bottleneck_v1/conv3/weights"]
    with pytest.raises(KeyError, match="conv3/weights"):  # the TF flag's path after its reader
        importers.load_params_tree(det, importers.apply_name_map(
            tree, values, name_maps.resnet_tf_faster_rcnn_map(50)))
    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        f.create_group("conv1_conv").create_dataset("kernel:0", data=np.zeros((3, 3, 3, 5)))
    with pytest.raises(ValueError, match="shape mismatch"):
        cli.load_checkpoint_params(det, path, _args("--keras_h5"))
    for k, v in det.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("flags,model_type,match", [
    (("--keras_h5", "--use_tf_faster_rcnn_model"), "faster_rcnn", "at most one"),
    (("--use_fpn_tensorflow_model", "--use_tf_faster_rcnn_model"), "fpn", "at most one"),
    (("--use_fpn_tensorflow_model",), "faster_rcnn", "model_type fpn"),
    (("--use_tf_faster_rcnn_model",), "fpn", "model_type faster_rcnn"),
])
def test_cli_refusals_match_jax(tmp_path, flags, model_type, match):
    """Two third-party flags, or a checkpoint flag for the other model type,
    raise ValueError in both packages, before the file is read."""
    det = _moved_detector(model_type)
    stand_in, _ = _jax_stand_in(det)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    path = str(tmp_path / "never_read.ckpt")
    with pytest.raises(ValueError, match=match):
        jax_cli.load_checkpoint_params(stand_in, path, _args(*flags))
    with pytest.raises(ValueError, match=match):
        cli.load_checkpoint_params(det, path, _args(*flags))
    assert all(torch.equal(v, before[k]) for k, v in det.state_dict().items())


# ------------------------------------------------------ --backbone_weights
def test_backbone_weights_slim_vgg16_prefix_matches_jax(tmp_path):
    """A slim `vgg_16` Saver prefix: the 13 convs, conv1_1's kernel with its
    INPUT channels reversed (axis 1 of the port's OIHW weight), every other
    layer untouched; ResNet backbones refuse the slim path."""
    tf = pytest.importorskip("tensorflow")
    det = _moved_detector("faster_rcnn", "vgg16")
    stand_in, start = _jax_stand_in(det)
    values = _slim_vgg16_values(start)
    ckpt = _write_saver_ckpt(tf, tmp_path, values, "vgg_16.ckpt")
    assert cli._is_tf_checkpoint(ckpt) and not cli._is_tf_checkpoint(str(tmp_path / "x.h5"))
    want = jax_cli.load_backbone_weights(stand_in, start, ckpt)
    cli.load_backbone_weights(det, ckpt)
    _assert_state_equals_jax(det, want)
    hwio = values["vgg_16/conv1/conv1_1/weights"]  # [3, 3, 3 in, 64 out], asymmetric
    oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
    got = det.state_dict()["extractor.block1_conv1.weight"]
    assert torch.equal(got, oihw.flip(1))
    assert not torch.equal(got, oihw) and not torch.equal(got, oihw.flip(0))
    assert torch.equal(det.state_dict()["extractor.block5_conv3.weight"], torch.from_numpy(
        values["vgg_16/conv5/conv5_3/weights"].transpose(3, 2, 0, 1).copy()))
    resnet = types.SimpleNamespace(model_type="faster_rcnn", backbone_name="resnet50")
    with pytest.raises(ValueError, match="vgg16"):
        cli.load_backbone_weights(resnet, ckpt)


@pytest.fixture
def offline_home(tmp_path, monkeypatch):
    """A temporary HOME for the download cache, and a `urlretrieve` that
    fails the test: nothing may reach the network."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))

    def no_network(*args, **kwargs):
        raise AssertionError(f"network access attempted: {args}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    return home


def _cached(home, url, h5py, det, tree):
    path = home / ".cache" / "tpu_od" / os.path.basename(url.partition("#")[0])
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_group("conv1_conv").create_group("conv1_conv").create_dataset(
            "kernel:0", data=_fill_for("cached", _layer_shape(tree, "conv1_conv", "kernel")))
    return hashlib.md5(path.read_bytes()).hexdigest()


def test_backbone_weights_urls_without_the_network(offline_home):
    """`http://` is refused; an `https` URL's `#md5=` is checked against the
    cached file (a mismatch raises in both packages, a match loads); an
    `https` URL without one warns and loads; `keras` resolves the
    reference's release file and checks its md5."""
    h5py = pytest.importorskip("h5py")
    det = _moved_detector("faster_rcnn", "resnet50")
    stand_in, start = _jax_stand_in(det)
    for mod, args in ((cli, (det,)), (jax_cli, (stand_in, start))):
        with pytest.raises(ValueError, match="plain-http"):
            mod.load_backbone_weights(*args, "http://example.invalid/w.h5")
    url = "https://example.invalid/weights/w.h5"
    digest = _cached(offline_home, url, h5py, det, start)
    for mod, args in ((cli, (det,)), (jax_cli, (stand_in, start))):
        with pytest.raises(ValueError, match="md5"):
            mod.load_backbone_weights(*args, url + "#md5=" + "0" * 32)
    want = jax_cli.load_backbone_weights(stand_in, start, url + "#md5=" + digest)
    cli.load_backbone_weights(det, url + "#md5=" + digest)
    _assert_state_equals_jax(det, want)
    with pytest.warns(UserWarning, match="WITHOUT checksum"):
        cli.load_backbone_weights(det, url)
    _assert_state_equals_jax(det, want)
    keras_url, keras_md5 = cli.KERAS_WEIGHT_URLS["resnet50"]
    assert cli.KERAS_WEIGHT_URLS == jax_cli.KERAS_WEIGHT_URLS
    assert _cached(offline_home, keras_url, h5py, det, start) != keras_md5
    for mod, args in ((cli, (det,)), (jax_cli, (stand_in, start))):
        with pytest.raises(ValueError, match=keras_md5):
            mod.load_backbone_weights(*args, "keras")


def test_trainer_backbone_weights_and_restore_precedence(tmp_path):
    """`Trainer(backbone_weights=)` loads the `.h5` over the seeded init; a
    checkpoint in the training directory takes precedence over it; the
    `train` command line passes the flag on."""
    h5py = pytest.importorskip("h5py")
    det = model_factory("faster_rcnn", "resnet50", _config("faster_rcnn", "resnet50"),
                        device="cpu")
    shape = importers.params_tree(det)["extractor"]["conv4_block2_2_conv"]["kernel"].shape
    want = _fill_for("conv4_block2_2_conv/kernel", shape)
    path = str(tmp_path / "backbone.h5")
    with h5py.File(path, "w") as f:  # one layer: by_name leaves the others at the init
        f.create_group("conv4_block2_2_conv").create_group("conv4_block2_2_conv").create_dataset(
            "kernel:0", data=want)
    logs = str(tmp_path / "logs")
    t1 = Trainer(det, logs, seed=3, backbone_weights=path)
    got = det.state_dict()
    assert torch.equal(got["extractor.conv4_block2_2_conv.weight"],
                       torch.from_numpy(want.transpose(3, 2, 0, 1).copy()))
    with torch.no_grad():
        for t in det.state_dict().values():
            t.mul_(-1.0)
    t1.ckpt.save(det, t1.optimizer)
    saved = {k: v.clone() for k, v in det.state_dict().items()}
    t1.close()
    Trainer(det, logs, seed=3, backbone_weights=path).close()  # re-initialized, then restored
    for k, v in det.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert train_cli.parse_args(["--backbone_weights", path]).backbone_weights == path


# --------------------------------------------------------------- .pth dicts
def test_pth_to_pickle_matches_jax(tmp_path):
    """`convert_pth_to_dict` (OIHW -> HWIO, 2-D transposed, others as they
    are) and `load_pickle_dict` equal JAX's on the same `.pth`."""
    gen = torch.Generator().manual_seed(0)
    state = {"conv.weight": torch.randn(8, 3, 3, 5, generator=gen),
             "conv.bias": torch.randn(8, generator=gen),
             "fc.weight": torch.randn(4, 6, generator=gen),
             "bn.running_var": torch.rand(8, generator=gen), "bn.num_batches_tracked":
             torch.tensor(3)}
    pth = str(tmp_path / "model.pth")
    torch.save(state, pth)
    got = pytorch_convert.convert_pth_to_dict(pth, str(tmp_path / "port.pkl"))
    want = jax_convert.convert_pth_to_dict(pth, str(tmp_path / "jax.pkl"))
    for out in (got, pytorch_convert.load_pickle_dict(str(tmp_path / "port.pkl")),
                jax_convert.load_pickle_dict(str(tmp_path / "port.pkl"))):
        assert out.keys() == want.keys()
        for k, v in want.items():
            assert out[k].dtype == v.dtype and np.array_equal(out[k], v), k
    assert got["conv.weight"].shape == (3, 5, 3, 8) and got["fc.weight"].shape == (6, 4)
    np.testing.assert_array_equal(got["conv.weight"][1, 2, 0, 7], state["conv.weight"][7, 0, 1, 2])
