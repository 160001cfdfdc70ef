"""ctypes wrapper of the CUDA NMS kernel (`csrc/nms.cu`).

`NMS_KERNEL(sorted_boxes, sorted_valid, iou_threshold, max_output)` launches
the kernel on PyTorch's current stream and returns the alive mask. It builds
the library on its first call and counts its launches in
`NMS_KERNEL.launches`. It takes CUDA tensors only; the plain PyTorch version
lives beside its caller in `ops/nms.py`.
"""

from __future__ import annotations

import ctypes

import torch

from tf_eager_object_detection_tpu_torch.ops.kernels.build import CudaKernel, device_and_stream

__all__ = ["CudaNms", "NMS_KERNEL"]

# removed-bitset words in the scan kernel's shared memory (48 KB, the most a
# launch gets without opting in) -> K <= 393216
_MAX_WORDS = 48 * 1024 // 8


class CudaNms(CudaKernel):
    name = "nms"
    sources = ("nms.cu",)
    entry = "nms_alive_sorted_cuda"
    error_fn = "nms_error_string"
    argtypes = (
        ctypes.c_void_p,  # boxes
        ctypes.c_void_p,  # valid
        ctypes.c_int,  # batch
        ctypes.c_int,  # k
        ctypes.c_float,  # thr
        ctypes.c_int,  # max_output
        ctypes.c_void_p,  # mask scratch
        ctypes.c_void_p,  # alive
        ctypes.c_int,  # device
        ctypes.c_void_p,  # stream
    )

    def __call__(
        self,
        sorted_boxes: torch.Tensor,
        sorted_valid: torch.Tensor,
        iou_threshold: float,
        max_output: int,
    ) -> torch.Tensor:
        """sorted_boxes [B, K, 4] f32, sorted_valid [B, K] bool -> alive [B, K] bool."""
        if sorted_boxes.device.type != "cuda" or sorted_valid.device != sorted_boxes.device:
            raise ValueError(
                f"CUDA NMS takes CUDA tensors on one device, got "
                f"{sorted_boxes.device} and {sorted_valid.device}"
            )
        if sorted_boxes.dtype != torch.float32 or sorted_valid.dtype != torch.bool:
            raise TypeError(
                f"CUDA NMS takes float32 boxes and bool valid, got "
                f"{sorted_boxes.dtype} and {sorted_valid.dtype}"
            )
        if sorted_boxes.dim() != 3 or sorted_boxes.shape[-1] != 4:
            raise ValueError(f"boxes must be [B, K, 4], got {tuple(sorted_boxes.shape)}")
        b, k, _ = sorted_boxes.shape
        if tuple(sorted_valid.shape) != (b, k):
            raise ValueError(
                f"valid must be [{b}, {k}], got {tuple(sorted_valid.shape)}"
            )
        if not (sorted_boxes.is_contiguous() and sorted_valid.is_contiguous()):
            raise ValueError("CUDA NMS takes contiguous tensors")
        words = -(-k // 64)
        if b < 1 or k < 1 or words > _MAX_WORDS or b > 65535:
            raise ValueError(f"CUDA NMS supports 1 <= B <= 65535, 1 <= K <= "
                             f"{_MAX_WORDS * 64}; got B={b}, K={k}")
        if max_output < 1:
            raise ValueError(f"max_output must be >= 1, got {max_output}")
        mask = torch.empty((b, k, words), dtype=torch.int64, device=sorted_boxes.device)
        alive = torch.empty((b, k), dtype=torch.uint8, device=sorted_boxes.device)
        self.launch(
            sorted_boxes.data_ptr(),
            sorted_valid.data_ptr(),
            b,
            k,
            float(iou_threshold),
            int(max_output),
            mask.data_ptr(),
            alive.data_ptr(),
            *device_and_stream(sorted_boxes.device),
        )
        return alive.view(torch.bool)


NMS_KERNEL = CudaNms()
