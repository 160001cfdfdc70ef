"""Trainable and frozen parameters (port of `tf_eager_object_detection_tpu/models/freeze.py`).

The reference freezes every BatchNorm, and for Faster R-CNN also VGG blocks
1-2 or the ResNet conv1 + conv2 stack; FPN keeps conv1 and conv2 trainable.
In the port every BatchNorm is already frozen: `FrozenBatchNorm` keeps its
statistics as buffers, which take no gradient. The other frozen tensors get
`requires_grad=False` (`freeze_`), so they take no gradient and no update.
Weight decay applies to the Conv2d / Linear `weight` of trainable modules,
never to a bias.
"""

from __future__ import annotations

from torch import nn

from tf_eager_object_detection_tpu_torch.models.backbones.vgg import VGG16_FROZEN_PREFIXES

__all__ = ["is_frozen", "trainable_mask", "weight_decay_mask", "freeze_"]


def is_frozen(name: str, backbone: str, model_type: str = "faster_rcnn") -> bool:
    """Whether the parameter `name` (a port name such as
    "extractor.conv2_block1_1_conv.weight") is frozen."""
    top, _, rest = name.partition(".")
    if top != "extractor" or model_type == "fpn":
        return False
    layer = rest.partition(".")[0]
    if backbone == "vgg16":
        return layer in VGG16_FROZEN_PREFIXES
    return layer.startswith(("conv1_", "conv2_"))


def trainable_mask(model: nn.Module) -> dict[str, bool]:
    """{parameter name: takes updates} under the model's freeze policy."""
    return {name: not is_frozen(name, model.backbone_name, model.model_type)
            for name, _ in model.named_parameters()}


def weight_decay_mask(model: nn.Module) -> dict[str, bool]:
    """{parameter name: takes L2 decay}: Conv2d / Linear weights of trainable modules."""
    trainable = trainable_mask(model)
    decayed = {f"{m}.weight" for m, mod in model.named_modules()
               if isinstance(mod, (nn.Conv2d, nn.Linear))}
    return {name: trainable[name] and name in decayed for name in trainable}


def freeze_(model: nn.Module) -> nn.Module:
    """Set requires_grad=False on the frozen parameters of `model`; returns it."""
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name, model.backbone_name, model.model_type))
    return model
