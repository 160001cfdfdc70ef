"""The package's CUDA kernels as PyTorch operators, in the `tf_eager_od`
namespace (`torch.ops.tf_eager_od.<name>`).

Each operator has three kernels:

- CUDA: the ctypes wrapper of `ops/kernels/*_cuda.py`, which builds its
  library on first use, launches on PyTorch's current stream and counts the
  launch; a build or launch that fails raises through the operator;
- CPU: the plain PyTorch version of `ops/nms.py` / `ops/roi_align.py`;
- fake: the output's shape and dtype from the inputs' alone, so that
  `torch.export` (and any other tracer) sees the operator as one opaque
  call whose data it never reads.

A tensor on any other device finds no kernel and raises. The operators:

- `nms_alive_sorted(boxes, valid, iou_threshold, max_output) -> alive`:
  K1, greedy NMS over score-sorted boxes [B, K, 4] f32 -> [B, K] bool.
- `roi_align(planes, rois, levels, valid, image_h, image_w, crop, strides)
  -> crops [B, N, S, S, C] f32`: K4, the fused-pyramid RoIAlign; called
  with one plane it is K2, the single-level kernel (its own launch count).
- `roi_align_backward(grad, planes, rois, levels, valid, image_h, image_w,
  crop, strides) -> [d plane]`: K5, or K3 with one plane; the gradient of
  each plane in the planes' dtype. Only the planes' shapes and dtypes are
  read. It is `roi_align`'s backward (`register_autograd`): the gradient
  goes to the planes alone, never to the rois, levels or masks.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL,
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
)
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    ROI_ALIGN_KERNEL,
    ROI_ALIGN_SINGLE_KERNEL,
)

__all__ = ["NAMESPACE", "nms_alive_sorted", "roi_align", "roi_align_backward"]

NAMESPACE = "tf_eager_od"

# The CPU kernels import the plain versions when first called: `ops/nms.py`
# and `ops/roi_align.py` import this module to call the operators.


# -------------------------------------------------------------------- K1
@torch.library.custom_op(f"{NAMESPACE}::nms_alive_sorted", mutates_args=(), device_types="cpu")
def nms_alive_sorted(boxes: Tensor, valid: Tensor, iou_threshold: float,
                     max_output: int) -> Tensor:
    from tf_eager_object_detection_tpu_torch.ops.nms import nms_alive_sorted_reference

    return nms_alive_sorted_reference(boxes, valid, iou_threshold, max_output).contiguous()


@nms_alive_sorted.register_kernel("cuda")
def _nms_alive_sorted_cuda(boxes, valid, iou_threshold, max_output):
    return NMS_KERNEL(boxes, valid, iou_threshold, max_output)


@nms_alive_sorted.register_fake
def _nms_alive_sorted_fake(boxes, valid, iou_threshold, max_output):
    return valid.new_empty(valid.shape, dtype=torch.bool)


# ------------------------------------------------------------- K4 / K2
@torch.library.custom_op(f"{NAMESPACE}::roi_align", mutates_args=(), device_types="cpu")
def roi_align(planes: list[Tensor], rois: Tensor, levels: Tensor, valid: Tensor,
              image_h: Tensor, image_w: Tensor, crop: int, strides: list[int]) -> Tensor:
    from tf_eager_object_detection_tpu_torch.ops.roi_align import roi_align_multilevel_reference

    return roi_align_multilevel_reference(planes, rois, levels, valid, image_h, image_w, crop,
                                          strides).contiguous()


@roi_align.register_kernel("cuda")
def _roi_align_cuda(planes, rois, levels, valid, image_h, image_w, crop, strides):
    kernel = ROI_ALIGN_SINGLE_KERNEL if len(planes) == 1 else ROI_ALIGN_KERNEL
    return kernel(planes, rois, levels, valid, image_h, image_w, crop, strides)


@roi_align.register_fake
def _roi_align_fake(planes, rois, levels, valid, image_h, image_w, crop, strides):
    b, n, _ = rois.shape
    return rois.new_empty((b, n, crop, crop, planes[0].shape[-1]), dtype=torch.float32)


# ------------------------------------------------------------- K5 / K3
@torch.library.custom_op(f"{NAMESPACE}::roi_align_backward", mutates_args=(),
                         device_types="cpu")
def roi_align_backward(grad: Tensor, planes: list[Tensor], rois: Tensor, levels: Tensor,
                       valid: Tensor, image_h: Tensor, image_w: Tensor, crop: int,
                       strides: list[int]) -> list[Tensor]:
    from tf_eager_object_detection_tpu_torch.ops.roi_align import (
        roi_align_multilevel_reference_backward,
    )

    return [d.contiguous() for d in roi_align_multilevel_reference_backward(
        grad, planes, rois, levels, valid, image_h, image_w, crop, strides)]


@roi_align_backward.register_kernel("cuda")
def _roi_align_backward_cuda(grad, planes, rois, levels, valid, image_h, image_w, crop,
                             strides):
    kernel = ROI_ALIGN_SINGLE_BACKWARD_KERNEL if len(planes) == 1 else ROI_ALIGN_BACKWARD_KERNEL
    return kernel(grad, [tuple(p.shape) for p in planes], rois, levels, valid, image_h,
                  image_w, crop, strides, planes[0].dtype)


@roi_align_backward.register_fake
def _roi_align_backward_fake(grad, planes, rois, levels, valid, image_h, image_w, crop,
                             strides):
    return [p.new_empty(p.shape) for p in planes]


def _roi_align_setup(ctx, inputs, output):
    planes, rois, levels, valid, image_h, image_w, crop, strides = inputs
    ctx.save_for_backward(rois, levels, valid, image_h, image_w, *planes)
    ctx.crop, ctx.strides = crop, strides


def _roi_align_grad(ctx, grad):
    rois, levels, valid, image_h, image_w, *planes = ctx.saved_tensors
    dplanes = roi_align_backward(grad.contiguous(), planes, rois, levels, valid, image_h,
                                 image_w, ctx.crop, ctx.strides)
    return list(dplanes), None, None, None, None, None, None, None


roi_align.register_autograd(_roi_align_grad, setup_context=_roi_align_setup)
