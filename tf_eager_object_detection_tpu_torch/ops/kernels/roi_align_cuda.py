"""ctypes wrappers of the CUDA RoIAlign forward kernel (`csrc/roi_align.cu`).

- `ROI_ALIGN_KERNEL(p_list, rois, levels, valid, image_height, image_width,
  crop_size, strides)`: the fused-pyramid forward (K4) -> [B, N, S, S, C].
- `ROI_ALIGN_SINGLE_KERNEL`: the same kernel, launched by
  `ops/roi_align.py::roi_align_single_level` with one plane (K2).

The backward wrappers (K5, K3) are in `roi_align_backward_cuda.py`. Each
launches on PyTorch's current stream, builds its library on first use
and counts its own launches in `.launches`. They take CUDA tensors only; the
plain PyTorch versions live beside their callers in `ops/roi_align.py`. The
image extents must fit the planes (a sample is clamped to the image's last
valid cell, which must lie on the plane). The forward moves 16-byte float4
units where `vectorizable` holds and single channels otherwise: a plane view
that is contiguous but not 16-byte aligned is taken, on the scalar path.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tf_eager_object_detection_tpu_torch.ops.kernels.build import CudaKernel, device_and_stream

__all__ = ["CudaRoiAlign", "ROI_ALIGN_KERNEL", "ROI_ALIGN_SINGLE_KERNEL", "vectorizable"]

_MAX_LEVELS = 8  # kMaxLevels of the source
_MAX_CROP = 64  # kMaxCrop: shared-memory coordinate slots per axis

# the C interface shared by the forward and the backward, with their `vec`
# flag between the two parts
_ARGS_HEAD = (
    ctypes.POINTER(ctypes.c_void_p),  # plane pointers (gradient planes for the backward)
    ctypes.POINTER(ctypes.c_int),  # heights
    ctypes.POINTER(ctypes.c_int),  # widths
    ctypes.POINTER(ctypes.c_float),  # strides
    ctypes.c_int,  # n_levels
    ctypes.c_void_p,  # rois
    ctypes.c_void_p,  # levels
    ctypes.c_void_p,  # valid
    ctypes.c_void_p,  # image_h
    ctypes.c_void_p,  # image_w
    ctypes.c_int,  # batch
    ctypes.c_int,  # n
    ctypes.c_int,  # c
    ctypes.c_int,  # crop
)
_ARGS_TAIL = (
    ctypes.c_void_p,  # out (grad_out for the backward)
    ctypes.c_int,  # device
    ctypes.c_void_p,  # stream
)


def vectorizable(p_list: Sequence[torch.Tensor], out: torch.Tensor) -> bool:
    """Whether a RoIAlign kernel moves 16-byte float4 units: C % 4 == 0 and
    every plane and `out` 16-byte aligned (else it takes its scalar path).
    The forward passes its planes and output, the backward its gradient
    planes and output gradient."""
    return out.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*p_list, out))


class CudaRoiAlign(CudaKernel):
    """The forward: `(p_list, rois, levels, valid, image_height, image_width,
    crop_size, strides) -> [B, N, S, S, C]`."""

    name = "roi_align"
    sources = ("roi_align.cu", "roi_align_common.cuh")
    entry = "roi_align_multilevel_cuda"
    error_fn = "roi_align_error_string"
    argtypes = (*_ARGS_HEAD, ctypes.c_int, *_ARGS_TAIL)  # vec: 1 for the float4 path

    @staticmethod
    def _check(p_list, rois, levels, valid, image_height, image_width, crop_size, strides):
        """Types, then shapes, then devices and layout; raises on what the kernel does not take."""
        tensors = [*p_list, rois, levels, valid, image_height, image_width]
        if not all(isinstance(t, torch.Tensor) for t in tensors):
            raise TypeError("CUDA RoIAlign takes tensors")
        want = [torch.float32] * (len(p_list) + 1) + [torch.int64, torch.bool,
                                                      torch.float32, torch.float32]
        got = [t.dtype for t in tensors]
        if got != want:
            raise TypeError(f"CUDA RoIAlign takes dtypes {want}, got {got}")
        if not 1 <= len(p_list) <= _MAX_LEVELS or len(strides) != len(p_list):
            raise ValueError(f"1 to {_MAX_LEVELS} planes with one stride each, got "
                             f"{len(p_list)} planes and {len(strides)} strides")
        if rois.dim() != 3 or rois.shape[-1] != 4:
            raise ValueError(f"rois must be [B, N, 4], got {tuple(rois.shape)}")
        b, n, _ = rois.shape
        c = p_list[0].shape[-1] if p_list[0].dim() == 4 else -1
        for p in p_list:
            if p.dim() != 4 or p.shape[0] != b or p.shape[-1] != c:
                raise ValueError(f"planes must be [{b}, H, W, C] with one C, got "
                                 f"{[tuple(q.shape) for q in p_list]}")
        if tuple(levels.shape) != (b, n) or tuple(valid.shape) != (b, n):
            raise ValueError(f"levels and valid must be [{b}, {n}], got "
                             f"{tuple(levels.shape)} and {tuple(valid.shape)}")
        if tuple(image_height.shape) != (b,) or tuple(image_width.shape) != (b,):
            raise ValueError(f"image extents must be [{b}], got "
                             f"{tuple(image_height.shape)} and {tuple(image_width.shape)}")
        if not 2 <= crop_size <= _MAX_CROP:
            raise ValueError(f"crop_size must be in [2, {_MAX_CROP}], got {crop_size}")
        if b < 1 or n < 1 or c < 1 or b * n * crop_size >= 2**31:
            raise ValueError(f"CUDA RoIAlign needs B, N, C >= 1 and B*N*S < 2**31 (the "
                             f"forward's grid); got B={b}, N={n}, C={c}, S={crop_size}")
        device = rois.device
        if device.type != "cuda" or any(t.device != device for t in tensors):
            raise ValueError(f"CUDA RoIAlign takes CUDA tensors on one device, got "
                             f"{sorted({str(t.device) for t in tensors})}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("CUDA RoIAlign takes contiguous tensors")

    def _launch(self, p_list, rois, levels, valid, image_height, image_width, crop_size,
                strides, out, *flags) -> None:
        """Launches on checked arguments, `flags` after the crop size and `out`
        as the last data pointer."""
        b, n, _ = rois.shape
        nl = len(p_list)
        self.launch(
            (ctypes.c_void_p * nl)(*[p.data_ptr() for p in p_list]),
            (ctypes.c_int * nl)(*[p.shape[1] for p in p_list]),
            (ctypes.c_int * nl)(*[p.shape[2] for p in p_list]),
            (ctypes.c_float * nl)(*[float(s) for s in strides]),
            nl,
            rois.data_ptr(),
            levels.data_ptr(),
            valid.data_ptr(),
            image_height.data_ptr(),
            image_width.data_ptr(),
            b,
            n,
            p_list[0].shape[-1],
            int(crop_size),
            *flags,
            out.data_ptr(),
            *device_and_stream(rois.device),
        )

    def __call__(
        self,
        p_list: Sequence[torch.Tensor],
        rois: torch.Tensor,
        levels: torch.Tensor,
        valid: torch.Tensor,
        image_height: torch.Tensor,
        image_width: torch.Tensor,
        crop_size: int,
        strides: Sequence[int],
    ) -> torch.Tensor:
        """p_list: per-level [B, H_l, W_l, C] f32; rois [B, N, 4] f32 xyxy pixels;
        levels [B, N] int64; valid [B, N] bool; image_height/width [B] f32
        -> [B, N, S, S, C] f32."""
        p_list = list(p_list)
        self._check(p_list, rois, levels, valid, image_height, image_width, crop_size, strides)
        b, n, _ = rois.shape
        out = torch.empty((b, n, crop_size, crop_size, p_list[0].shape[-1]),
                          dtype=torch.float32, device=rois.device)
        self._launch(p_list, rois, levels, valid, image_height, image_width, crop_size, strides,
                     out, int(vectorizable(p_list, out)))
        return out


ROI_ALIGN_KERNEL = CudaRoiAlign()  # K4
ROI_ALIGN_SINGLE_KERNEL = CudaRoiAlign()  # K2: one plane
