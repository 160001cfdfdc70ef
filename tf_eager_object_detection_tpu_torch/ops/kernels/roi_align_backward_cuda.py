"""ctypes wrappers of the CUDA RoIAlign backward kernel (`csrc/roi_align_backward.cu`).

- `ROI_ALIGN_BACKWARD_KERNEL(grad, plane_shapes, rois, levels, valid,
  image_height, image_width, crop_size, strides)`: the fused-pyramid
  backward (K5) -> one gradient per plane, fresh zeros plus the scatter.
- `ROI_ALIGN_SINGLE_BACKWARD_KERNEL`: the same kernel, launched by the
  `tf_eager_od::roi_align_backward` operator (`library.py`) for one plane (K3).

Arguments are checked and passed as for the forward (`roi_align_cuda.py`),
with the output gradient in place of the output: the kernel adds 16-byte
float4 units where `vectorizable(gradient planes, grad)` holds (C % 4 == 0,
every pointer 16-byte aligned) and single channels otherwise. The gradient
is that of the CUDA forward, where a tap past the plane weighs 0 and adds
nothing. Each wrapper launches on PyTorch's current stream, builds its
library on first use and counts its own launches in `.launches`; CUDA
tensors only.

Gradients of bfloat16 planes: the kernel adds into float32 accumulation
planes (a bfloat16 atomic would lose most of a sum) and the wrapper
rounds them to bfloat16 as its last step, as the Pallas VJP accumulates in
float32 and casts to the primal dtype. The launch counts under the planes'
dtype (`launches_by_dtype`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    _ARGS_HEAD,
    _ARGS_TAIL,
    PLANE_DTYPES,
    CudaRoiAlign,
    vectorizable,
)

__all__ = ["CudaRoiAlignBackward", "ROI_ALIGN_BACKWARD_KERNEL", "ROI_ALIGN_SINGLE_BACKWARD_KERNEL"]


class CudaRoiAlignBackward(CudaRoiAlign):
    """The backward: `(grad, plane_shapes, rois, levels, valid, image_height,
    image_width, crop_size, strides, plane_dtype=float32) -> [d plane for
    each shape]`."""

    name = "roi_align_backward"
    sources = ("roi_align_backward.cu", "roi_align_common.cuh")
    entry = "roi_align_multilevel_backward_cuda"
    error_fn = "roi_align_backward_error_string"
    argtypes = (*_ARGS_HEAD, ctypes.c_int, *_ARGS_TAIL)  # vec: 1 for the float4 path

    def __call__(self, *args, **kwargs) -> list[torch.Tensor]:
        """The gradient of each plane, in the planes' dtype (`accumulate`'s
        first result)."""
        return self.accumulate(*args, **kwargs)[0]

    def accumulate(
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
        plane_dtype: torch.dtype = torch.float32,
    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """grad [B, N, S, S, C] f32; plane_shapes: the forward's [B, H_l, W_l, C];
        plane_dtype: the forward's planes' (float32 or bfloat16) -> (the
        gradient of each plane in `plane_dtype`, the float32 planes the
        kernel added into; the same tensors for float32). The gradient is
        checked first, then the rest as for the forward."""
        if not isinstance(grad, torch.Tensor) or grad.dtype != torch.float32:
            raise TypeError("CUDA RoIAlign backward takes a float32 gradient")
        if plane_dtype not in PLANE_DTYPES:
            raise TypeError(f"CUDA RoIAlign backward returns planes of {PLANE_DTYPES}, "
                            f"not {plane_dtype}")
        want = (*rois.shape[:2], crop_size, crop_size, plane_shapes[0][-1])
        if tuple(grad.shape) != want or grad.device != rois.device or not grad.is_contiguous():
            raise ValueError(f"the gradient must be a contiguous {list(want)} tensor on "
                             f"{rois.device}, got {tuple(grad.shape)} on {grad.device}")
        dfs = [torch.zeros(tuple(s), dtype=torch.float32, device=rois.device)
               for s in plane_shapes]
        self._check(dfs, rois, levels, valid, image_height, image_width, crop_size, strides)
        self._launch(dfs, rois, levels, valid, image_height, image_width, crop_size, strides,
                     grad, int(vectorizable(dfs, grad)), variant=plane_dtype)
        return [d.to(plane_dtype) for d in dfs], dfs


ROI_ALIGN_BACKWARD_KERNEL = CudaRoiAlignBackward()  # K5
ROI_ALIGN_SINGLE_BACKWARD_KERNEL = CudaRoiAlignBackward()  # K3: one plane
