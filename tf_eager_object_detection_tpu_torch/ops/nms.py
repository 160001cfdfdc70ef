"""Fixed-shape non-maximum suppression (port of `tf_eager_object_detection_tpu/ops/nms.py`).

Semantics of `tf.image.non_max_suppression`: IoU *without* the +1 pixel
convention, suppression on `iou > threshold` (strict), ties in score broken
by original index (stable sort), at most `max_output` kept. Every function
takes a leading batch dimension: one row per image (the RPN) or per class
(the per-class NMS). Shapes are static; validity is carried in masks.

`nms_alive_sorted` calls the `tf_eager_od::nms_alive_sorted` operator
(`ops/kernels/library.py`): on a CUDA tensor the hand-written kernel
(`csrc/nms.cu`), on a CPU tensor `nms_alive_sorted_reference`, the plain
PyTorch version of the same function. The plain version reads back to the
host to end its loop, so to a tracer (`torch.export`) the operator is one
opaque call on either device.
"""

from __future__ import annotations

import torch

# registers the tf_eager_od operators that `nms_alive_sorted` calls
from tf_eager_object_detection_tpu_torch.ops.kernels import library  # noqa: F401

__all__ = [
    "nms_alive_sorted",
    "nms_alive_sorted_reference",
    "non_max_suppression",
    "compact_alive",
]

# boxes per block of the plain version (the block of `_nms_alive_sorted_xla`)
_BLOCK = 256


def _nms_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with TF-NMS conventions (no +1). [B,N,4]x[B,M,4] -> [B,N,M]."""
    x11, y11, x12, y12 = boxes1.unsqueeze(-2).unbind(-1)  # [B, N, 1]
    x21, y21, x22, y22 = boxes2.unsqueeze(-3).unbind(-1)  # [B, 1, M]
    iw = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp_min(0.0)
    ih = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp_min(0.0)
    inter = iw * ih
    a1 = (x12 - x11) * (y12 - y11)
    a2 = (x22 - x21) * (y22 - y21)
    union = a1 + a2 - inter
    iou = inter / union.clamp_min(1e-12)
    return torch.where(inter > 0.0, iou, torch.zeros_like(iou))


def _self_suppress(ov_earlier: torch.Tensor, init_alive: torch.Tensor) -> torch.Tensor:
    """Greedy NMS inside one block by fixpoint iteration.

    ov_earlier[b, i, j]: i precedes j in score order and IoU > t. Iterates
    a[j] <- init[j] & !any_i(a[i] & ov[i, j]) until stable, which is the
    sequential greedy answer after at most one round per box of the block.
    """
    alive = init_alive
    for _ in range(ov_earlier.shape[-1] + 1):
        killed = (alive.unsqueeze(-1) & ov_earlier).any(dim=-2)
        nxt = init_alive & ~killed
        if torch.equal(nxt, alive):
            break
        alive = nxt
    return alive


def nms_alive_sorted_reference(
    sorted_boxes: torch.Tensor,
    sorted_valid: torch.Tensor,
    iou_threshold: float,
    max_output: int,
) -> torch.Tensor:
    """Plain PyTorch blockwise NMS over score-sorted boxes -> alive [B, K] bool.

    Mirrors `_nms_alive_sorted_xla`: blocks of `_BLOCK` boxes, each resolved by
    an in-block fixpoint and then suppressing every later box; stops once
    every row has `max_output` kept, then clears survivors beyond
    `max_output` by kept rank. Reads back to the host to stop its loops.
    """
    b, k, _ = sorted_boxes.shape
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=sorted_boxes.device)
    k_pad = -(-k // _BLOCK) * _BLOCK
    boxes = torch.nn.functional.pad(sorted_boxes.float(), (0, 0, 0, k_pad - k))
    alive = torch.nn.functional.pad(sorted_valid, (0, k_pad - k))
    pos = torch.arange(k_pad, device=boxes.device)
    earlier = torch.ones(_BLOCK, _BLOCK, dtype=torch.bool, device=boxes.device).triu(1)
    kept = torch.zeros(b, dtype=torch.int64, device=boxes.device)
    for start in range(0, k_pad, _BLOCK):
        if bool((kept >= max_output).all()):
            break
        blk_boxes = boxes[:, start : start + _BLOCK]
        ov = (_nms_iou(blk_boxes, blk_boxes) > thr) & earlier
        blk_alive = _self_suppress(ov, alive[:, start : start + _BLOCK])
        hit = blk_alive.unsqueeze(-1) & (_nms_iou(blk_boxes, boxes) > thr)
        killed_tail = hit.any(dim=-2) & (pos >= start + _BLOCK)
        alive = alive & ~killed_tail
        alive[:, start : start + _BLOCK] = blk_alive
        kept = kept + blk_alive.sum(dim=-1)
    rank = torch.cumsum(alive.to(torch.int64), dim=-1) - 1
    return (alive & (rank < max_output))[:, :k]


def nms_alive_sorted(
    sorted_boxes: torch.Tensor,
    sorted_valid: torch.Tensor,
    iou_threshold: float,
    max_output: int,
) -> torch.Tensor:
    """NMS over boxes ALREADY in score-descending order -> alive [B, K] bool.

    sorted_boxes [B, K, 4] float32 xyxy; sorted_valid [B, K] bool.
    """
    return torch.ops.tf_eager_od.nms_alive_sorted(
        sorted_boxes.float().contiguous(), sorted_valid.contiguous(), float(iou_threshold),
        int(max_output),
    )


def compact_alive(alive: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of the first `size` alive slots per row, fixed shape.

    The counterpart of `jnp.nonzero(alive, size=size, fill_value=K)` with no
    host sync: a cumsum rank, then a scatter into a [B, size] tensor filled
    with K. Returns (pos [B, size] int64, out_valid [B, size] bool).
    """
    b, k = alive.shape
    rank = torch.cumsum(alive.to(torch.int64), dim=-1) - 1
    slot = torch.where(alive & (rank < size), rank, torch.full_like(rank, size))
    pos = torch.full((b, size + 1), k, dtype=torch.int64, device=alive.device)
    src = torch.arange(k, device=alive.device).expand(b, k)
    pos.scatter_(1, slot, src)  # every non-kept slot lands in the dropped column
    pos = pos[:, :size]
    return pos, pos < k


def non_max_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor | None,
    max_output: int,
    iou_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """TF-compatible NMS over padded boxes, batched over the leading axis.

    boxes [B, K, 4] xyxy; scores [B, K]; valid [B, K] bool or None.
    Returns indices [B, max_output] int64 into K (score-descending, 0 where
    invalid) and out_valid [B, max_output] bool.
    """
    b, k = scores.shape
    if valid is None:
        valid = torch.ones((b, k), dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order.unsqueeze(-1).expand(b, k, 4))
    svalid = torch.gather(valid, 1, order)
    alive = nms_alive_sorted(sboxes, svalid, iou_threshold, max_output)
    pos, out_valid = compact_alive(alive, max_output)
    indices = torch.gather(order, 1, pos.clamp_max(k - 1))
    return torch.where(out_valid, indices, torch.zeros_like(indices)), out_valid
