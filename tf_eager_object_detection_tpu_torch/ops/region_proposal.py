"""Region proposal (port of `tf_eager_object_detection_tpu/ops/region_proposal.py`).

Decode the RPN deltas of every anchor, clip to each image's valid extent,
order by score once (that order serves as both the pre-NMS top-k and NMS's
processing order), NMS with `num_post_nms` output slots, and compact the
survivors. Batched over images: the whole batch is one NMS call.
"""

from __future__ import annotations

import torch

from tf_eager_object_detection_tpu_torch.core.boxes import clip_boxes
from tf_eager_object_detection_tpu_torch.core.transforms import decode_boxes
from tf_eager_object_detection_tpu_torch.ops.nms import compact_alive, nms_alive_sorted

__all__ = ["region_proposal"]


def region_proposal(
    rpn_deltas: torch.Tensor,
    anchors: torch.Tensor,
    scores: torch.Tensor,
    anchor_valid: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    num_post_nms: int,
    nms_iou_threshold: float = 0.7,
    num_pre_nms: int | None = None,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
    clip_deltas: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (rois [B, num_post_nms, 4], roi_valid [B, num_post_nms] bool).

    rpn_deltas [B, A, 4]; anchors [A, 4]; scores [B, A] objectness
    probabilities; anchor_valid [B, A] bool; image_height/width [B].
    """
    decoded = decode_boxes(
        anchors, rpn_deltas, target_means, target_stds, clip_deltas=clip_deltas
    )
    decoded = clip_boxes(decoded, image_height[:, None], image_width[:, None])

    masked = torch.where(
        anchor_valid, scores, torch.full_like(scores, float("-inf"))
    )
    b, k = masked.shape
    # stable sort: ties in score go to the lower index, like lax.top_k
    # (torch.topk on CUDA does not promise an order among ties)
    top_scores, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    if num_pre_nms is not None and num_pre_nms < k:
        top_scores, order = top_scores[:, :num_pre_nms], order[:, :num_pre_nms]
    svalid = top_scores > float("-inf")
    n = order.shape[1]
    sboxes = torch.gather(decoded, 1, order.unsqueeze(-1).expand(b, n, 4))

    alive = nms_alive_sorted(sboxes, svalid, nms_iou_threshold, num_post_nms)
    pos, out_valid = compact_alive(alive, num_post_nms)
    rois = torch.gather(sboxes, 1, pos.clamp_max(n - 1).unsqueeze(-1).expand(-1, -1, 4))
    rois = torch.where(out_valid.unsqueeze(-1), rois, torch.zeros_like(rois))
    return rois, out_valid
