"""ctypes wrappers of the CUDA RoIAlign backward kernel (`csrc/roi_align_backward.cu`).

- `ROI_ALIGN_BACKWARD_KERNEL(grad, plane_shapes, rois, levels, valid,
  image_height, image_width, crop_size, strides)`: the fused-pyramid
  backward (K5) -> one gradient per plane, fresh zeros plus the scatter.
- `ROI_ALIGN_SINGLE_BACKWARD_KERNEL`: the same kernel, launched by
  `ops/roi_align.py::RoIAlignSingleLevel` with one plane (K3).

Arguments are checked and passed as for the forward (`roi_align_cuda.py`),
with the output gradient in place of the output: the kernel adds 16-byte
float4 units where `vectorizable(gradient planes, grad)` holds (C % 4 == 0,
every pointer 16-byte aligned) and single channels otherwise. The gradient
is that of the CUDA forward: where an image's last valid cell lies past a
plane, a tap clamped onto the plane's last cell adds there, as the forward
reads it. Each wrapper launches on PyTorch's current stream, builds its
library on first use and counts its own launches in `.launches`; CUDA
tensors only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    CudaRoiAlign,
    vectorizable,
)

__all__ = ["CudaRoiAlignBackward", "ROI_ALIGN_BACKWARD_KERNEL", "ROI_ALIGN_SINGLE_BACKWARD_KERNEL"]


class CudaRoiAlignBackward(CudaRoiAlign):
    """The backward: `(grad, plane_shapes, rois, levels, valid, image_height,
    image_width, crop_size, strides) -> [d plane for each shape]`."""

    name = "roi_align_backward"
    sources = ("roi_align_backward.cu", "roi_align_common.cuh")
    entry = "roi_align_multilevel_backward_cuda"
    error_fn = "roi_align_backward_error_string"

    def __call__(
        self,
        grad: torch.Tensor,
        plane_shapes: Sequence[Sequence[int]],
        rois: torch.Tensor,
        levels: torch.Tensor,
        valid: torch.Tensor,
        image_height: torch.Tensor,
        image_width: torch.Tensor,
        crop_size: int,
        strides: Sequence[int],
    ) -> list[torch.Tensor]:
        """grad [B, N, S, S, C] f32; plane_shapes: the forward's [B, H_l, W_l, C]
        -> the gradient of each plane, f32 of its shape. The gradient is
        checked first, then the rest as for the forward."""
        if not isinstance(grad, torch.Tensor) or grad.dtype != torch.float32:
            raise TypeError("CUDA RoIAlign backward takes a float32 gradient")
        want = (*rois.shape[:2], crop_size, crop_size, plane_shapes[0][-1])
        if tuple(grad.shape) != want or grad.device != rois.device or not grad.is_contiguous():
            raise ValueError(f"the gradient must be a contiguous {list(want)} tensor on "
                             f"{rois.device}, got {tuple(grad.shape)} on {grad.device}")
        dfs = [torch.zeros(tuple(s), dtype=torch.float32, device=rois.device)
               for s in plane_shapes]
        self._check(dfs, rois, levels, valid, image_height, image_width, crop_size, strides)
        self._launch(dfs, rois, levels, valid, image_height, image_width, crop_size, strides,
                     grad, int(vectorizable(dfs, grad)))
        return dfs


ROI_ALIGN_BACKWARD_KERNEL = CudaRoiAlignBackward()  # K5
ROI_ALIGN_SINGLE_BACKWARD_KERNEL = CudaRoiAlignBackward()  # K3: one plane
