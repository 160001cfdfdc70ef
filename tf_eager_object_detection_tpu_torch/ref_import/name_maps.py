"""Checkpoint name maps: third-party checkpoint prefixes -> the port's layers
(the port's own copy of `tf_eager_object_detection_tpu/ref_import/name_maps.py`).

Programmatic reconstruction of the reference's import tables:
- vgg16 slim / tf-faster-rcnn (vgg16_faster_rcnn.py:117-171, :357-390)
- resnet tf-faster-rcnn (resnet_faster_rcnn.py:295-446)
- FPN_Tensorflow (resnet_fpn.py:544-700)

Each map is {ckpt_prefix: (top_module, layer_name)} where ckpt tensors are at
prefix + {'weights', 'biases'} (convs/dense) or prefix +
{'gamma','beta','moving_mean','moving_variance'} (BatchNorm). The port's
layers carry the keras names of the flax ones (`extractor.conv1_conv`,
`roi_head.fc1`, ...), so (top_module, layer_name) names the same layer in
both packages: `params[top_module][layer_name]` in the flax layout and
`{top_module}.{layer_name}` in the port's state_dict.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = [
    "vgg16_slim_backbone_map",
    "vgg16_tf_faster_rcnn_map",
    "resnet_tf_faster_rcnn_map",
    "fpn_tensorflow_map",
    "RESNET_STACK_BLOCKS",
]

RESNET_STACK_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

MapType = Dict[str, Tuple[str, str]]


def vgg16_slim_backbone_map() -> MapType:
    out: MapType = {}
    blocks = ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
    for block, n in blocks:
        for i in range(1, n + 1):
            out[f"vgg_16/conv{block}/conv{block}_{i}/"] = (
                "extractor",
                f"block{block}_conv{i}",
            )
    return out


def vgg16_tf_faster_rcnn_map() -> MapType:
    out = vgg16_slim_backbone_map()
    out.update(
        {
            "vgg_16/rpn_conv/3x3/": ("rpn_head", "rpn_first_conv"),
            "vgg_16/rpn_cls_score/": ("rpn_head", "rpn_score_conv"),
            "vgg_16/rpn_bbox_pred/": ("rpn_head", "rpn_bbox_conv"),
            "vgg_16/fc6/": ("roi_head", "fc1"),
            "vgg_16/fc7/": ("roi_head", "fc2"),
            "vgg_16/cls_score/": ("roi_head", "roi_head_score"),
            "vgg_16/bbox_pred/": ("roi_head", "roi_head_bboxes"),
        }
    )
    return out


def _resnet_slim_stack_entries(
    prefix: str, slim_block: str, keras_stack: str, units: int, top: str
) -> MapType:
    out: MapType = {}
    fmt = f"{prefix}/{slim_block}/{{}}/bottleneck_v1/{{}}/"
    out[fmt.format("unit_1", "shortcut")] = (top, f"{keras_stack}_block1_0_conv")
    out[fmt.format("unit_1", "shortcut") + "BatchNorm/"] = (
        top,
        f"{keras_stack}_block1_0_bn",
    )
    for i in range(1, units + 1):
        for j in range(1, 4):
            out[fmt.format(f"unit_{i}", f"conv{j}")] = (
                top,
                f"{keras_stack}_block{i}_{j}_conv",
            )
            out[fmt.format(f"unit_{i}", f"conv{j}") + "BatchNorm/"] = (
                top,
                f"{keras_stack}_block{i}_{j}_bn",
            )
    return out


def resnet_tf_faster_rcnn_map(depth: int) -> MapType:
    """tf-faster-rcnn resnet checkpoints: extractor (conv1..conv4) + rpn head
    + roi head (conv5 + Dense heads). Slim convs have no biases -> importer
    zero-fills ours."""
    prefix = f"resnet_v1_{depth}"
    u2, u3, u4, u5 = RESNET_STACK_BLOCKS[depth]
    out: MapType = {
        f"{prefix}/conv1/": ("extractor", "conv1_conv"),
        f"{prefix}/conv1/BatchNorm/": ("extractor", "conv1_bn"),
        f"{prefix}/rpn_conv/3x3/": ("rpn_head", "rpn_first_conv"),
        f"{prefix}/rpn_cls_score/": ("rpn_head", "rpn_score_conv"),
        f"{prefix}/rpn_bbox_pred/": ("rpn_head", "rpn_bbox_conv"),
        f"{prefix}/cls_score/": ("roi_head", "roi_head_score"),
        f"{prefix}/bbox_pred/": ("roi_head", "roi_head_bboxes"),
    }
    out.update(_resnet_slim_stack_entries(prefix, "block1", "conv2", u2, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block2", "conv3", u3, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block3", "conv4", u4, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block4", "conv5", u5, "roi_head"))
    return out


def fpn_tensorflow_map(depth: int = 50) -> MapType:
    """FPN_Tensorflow checkpoints: resnet extractor (conv1..conv5) + neck +
    shared rpn head + fc roi head (resnet_fpn.py:544-700)."""
    prefix = f"resnet_v1_{depth}"
    u2, u3, u4, u5 = RESNET_STACK_BLOCKS[depth]
    out: MapType = {
        f"{prefix}/conv1/": ("extractor", "conv1_conv"),
        f"{prefix}/conv1/BatchNorm/": ("extractor", "conv1_bn"),
        "build_rpn/rpn_conv/3x3/": ("rpn_head", "rpn_first_conv"),
        "build_rpn/rpn_cls_score/": ("rpn_head", "rpn_score_conv"),
        "build_rpn/rpn_bbox_pred/": ("rpn_head", "rpn_bbox_conv"),
        "Fast-RCNN/build_fc_layers/fc1/": ("roi_head", "fc1"),
        "Fast-RCNN/build_fc_layers/fc2/": ("roi_head", "fc2"),
        "Fast-RCNN/cls_fc/": ("roi_head", "roi_head_score"),
        "Fast-RCNN/reg_fc/": ("roi_head", "roi_head_bboxes"),
        "build_pyramid/build_P5/": ("neck", "build_p5"),
        "build_pyramid/build_P4/reduce_dim_P4/": ("neck", "build_p4_reduce_dims"),
        "build_pyramid/fuse_P4/": ("neck", "build_p4"),
        "build_pyramid/build_P3/reduce_dim_P3/": ("neck", "build_p3_reduce_dims"),
        "build_pyramid/fuse_P3/": ("neck", "build_p3"),
        "build_pyramid/build_P2/reduce_dim_P2/": ("neck", "build_p2_reduce_dims"),
        "build_pyramid/fuse_P2/": ("neck", "build_p2"),
    }
    out.update(_resnet_slim_stack_entries(prefix, "block1", "conv2", u2, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block2", "conv3", u3, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block3", "conv4", u4, "extractor"))
    out.update(_resnet_slim_stack_entries(prefix, "block4", "conv5", u5, "extractor"))
    return out
