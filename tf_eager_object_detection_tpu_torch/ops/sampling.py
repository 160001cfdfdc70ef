"""RPN and RoI training targets (port of `tf_eager_object_detection_tpu/ops/sampling.py`).

Fixed shapes, masks instead of dynamic gathers, and the batch dimension
explicit. Random subsampling gives every candidate a uniform priority and
keeps the highest: a stable descending sort, so ties (the -inf of
non-candidates) go to the lower index as in `lax.top_k`. The random numbers
come in as tensors (`TrainDraws`), so a test can hand both frameworks the
same draws; the scarce-background refill samples with replacement as
`jax.random.categorical` does, by the argmax of Gumbel noise plus logits.

`strict_class_column=True` reproduces the reference's class-column indexing
and ascending slot order, as the JAX module documents. Neither function
reads a tensor back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tf_eager_object_detection_tpu_torch.core.boxes import inside_image_mask, pairwise_iou
from tf_eager_object_detection_tpu_torch.core.transforms import encode_boxes

__all__ = ["anchor_target", "proposal_target", "AnchorTargets", "ProposalTargets", "TrainDraws"]


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # [B, A] int64: -1 ignore / 0 bg / 1 fg
    bbox_targets: torch.Tensor  # [B, A, 4]
    in_weights: torch.Tensor  # [B, A, 4]
    out_weights: torch.Tensor  # [B, A, 4]


class ProposalTargets(NamedTuple):
    rois: torch.Tensor  # [B, S, 4]
    labels: torch.Tensor  # [B, S] int64 class ids (0 = bg)
    bbox_targets: torch.Tensor  # [B, S, num_classes * 4]
    in_weights: torch.Tensor  # [B, S, num_classes * 4]
    out_weights: torch.Tensor  # [B, S, num_classes * 4]
    valid: torch.Tensor  # [B, S] bool (all True unless an image has no roi)


class TrainDraws(NamedTuple):
    """The random numbers of one training step's samplers.

    anchor_fg / anchor_bg [B, A] and roi_fg / roi_bg [B, R]: uniform
    priorities in [0, 1); roi_bg_gumbel [B, S, R]: Gumbel noise for the
    with-replacement background draw.
    """

    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor
    roi_bg_gumbel: torch.Tensor

    @classmethod
    def sample(cls, generator: torch.Generator, batch: int, num_anchors: int, num_rois: int,
               num_samples: int) -> "TrainDraws":
        """Fresh draws from `generator`, on its device."""
        kw = dict(generator=generator, device=generator.device)

        def uniform(*shape):
            return torch.rand(shape, **kw)

        tiny = torch.finfo(torch.float32).tiny
        u = uniform(batch, num_samples, num_rois).clamp_min(tiny)
        return cls(uniform(batch, num_anchors), uniform(batch, num_anchors),
                   uniform(batch, num_rois), uniform(batch, num_rois), -torch.log(-torch.log(u)))


def _top(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim; ties to the
    lower index, like `lax.top_k`."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def _mark(like: torch.Tensor, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Bool [..., N] that is `flags` at `idx` (distinct per row) and False elsewhere."""
    return torch.zeros_like(like, dtype=torch.bool).scatter(-1, idx, flags)


def _neg_inf_where_not(cand: torch.Tensor, pri: torch.Tensor) -> torch.Tensor:
    return torch.where(cand, pri, torch.full_like(pri, float("-inf")))


def _select_topk_random(candidates: torch.Tensor, k: int, pri: torch.Tensor) -> torch.Tensor:
    """min(k, count) of `candidates` [B, N], those of highest priority -> [B, N] bool."""
    _, idx = _top(_neg_inf_where_not(candidates, pri), min(k, candidates.shape[-1]))
    return _mark(candidates, idx, torch.ones_like(idx, dtype=torch.bool)) & candidates


def anchor_target(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    fg_priority: torch.Tensor,
    bg_priority: torch.Tensor,
    pos_iou_threshold: float = 0.7,
    neg_iou_threshold: float = 0.3,
    total_num_samples: int = 256,
    max_pos_samples: int = 128,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
) -> AnchorTargets:
    """RPN targets over all (padded) anchors.

    anchors [A, 4] xyxy; gt_boxes [B, G, 4]; gt_mask [B, G] bool;
    image_height/width [B] valid extents; fg/bg_priority [B, A] uniform draws.
    """
    a = anchors.shape[0]
    inside = inside_image_mask(anchors, image_height[:, None], image_width[:, None])  # [B, A]

    iou = pairwise_iou(anchors.expand(gt_boxes.shape[0], a, 4), gt_boxes, mask2=gt_mask)
    iou = torch.where(inside[..., None] & gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))
    max_overlaps = iou.max(dim=-1).values  # [B, A]; -1 rows for outside anchors
    argmax_overlaps = iou.argmax(dim=-1)  # the first maximum, as jnp.argmax
    gt_max = iou.max(dim=-2).values  # [B, G]

    # bg below the negative threshold; each gt's best anchors and anchors
    # above the positive threshold are fg; outside anchors are ignored
    labels = torch.full_like(max_overlaps, -1, dtype=torch.long)
    labels = torch.where(max_overlaps < neg_iou_threshold, torch.zeros_like(labels), labels)
    best = gt_max[:, None, :]
    is_gt_argmax = ((iou == best) & gt_mask[:, None, :] & (best >= 0.0)).any(dim=-1)
    labels = torch.where(is_gt_argmax & inside, torch.ones_like(labels), labels)
    labels = torch.where(max_overlaps >= pos_iou_threshold, torch.ones_like(labels), labels)
    labels = torch.where(inside, labels, torch.full_like(labels, -1))

    # at most max_pos_samples fg, then total - num_fg bg (a dynamic count:
    # take a static top-k and keep its first num_bg)
    fg = labels == 1
    fg_kept = _select_topk_random(fg, max_pos_samples, fg_priority)
    labels = torch.where(fg & ~fg_kept, torch.full_like(labels, -1), labels)
    num_bg = total_num_samples - fg_kept.sum(dim=-1, keepdim=True)  # [B, 1]
    bg = labels == 0
    k_bg = min(total_num_samples, a)
    bg_vals, bg_idx = _top(_neg_inf_where_not(bg, bg_priority), k_bg)
    rank = torch.arange(k_bg, device=anchors.device)
    bg_kept = _mark(bg, bg_idx, (rank < num_bg) & (bg_vals > float("-inf")))
    labels = torch.where(bg & ~bg_kept, torch.full_like(labels, -1), labels)

    # regression targets against the best gt of every inside anchor
    matched_gt = torch.gather(gt_boxes, 1, argmax_overlaps[..., None].expand(-1, -1, 4))
    bbox_targets = encode_boxes(anchors.expand_as(matched_gt), matched_gt, target_means,
                                target_stds)
    bbox_targets = torch.where(inside[..., None], bbox_targets, torch.zeros_like(bbox_targets))

    ones = torch.ones_like(bbox_targets)
    in_weights = torch.where((labels == 1)[..., None], ones, torch.zeros_like(ones))
    num_examples = (labels >= 0).float().sum(dim=-1, keepdim=True)
    out_w = 1.0 / num_examples.clamp_min(1.0)  # [B, 1]
    out_weights = torch.where((labels >= 0)[..., None], out_w[..., None] * ones,
                              torch.zeros_like(ones))
    return AnchorTargets(labels, bbox_targets, in_weights, out_weights)


def proposal_target(
    rois: torch.Tensor,
    roi_mask: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_labels: torch.Tensor,
    fg_priority: torch.Tensor,
    bg_priority: torch.Tensor,
    bg_gumbel: torch.Tensor,
    num_classes: int = 21,
    pos_iou_threshold: float = 0.5,
    neg_iou_threshold: float = 0.0,
    total_num_samples: int = 128,
    max_pos_samples: int = 32,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(0.1, 0.1, 0.2, 0.2),
    strict_class_column: bool = False,
) -> ProposalTargets:
    """RoI-head batch of exactly `total_num_samples` rois per image: fg slots
    first, then bg.

    rois [B, R, 4] with roi_mask [B, R]; gt_labels [B, G] (class ids >= 1);
    fg/bg_priority [B, R] uniform draws; bg_gumbel [B, S, R] Gumbel noise.
    """
    bsz, r = rois.shape[:2]
    s = total_num_samples
    dev = rois.device
    neg_inf = float("-inf")

    iou = pairwise_iou(rois, gt_boxes, mask2=gt_mask)  # [B, R, G]
    iou = torch.where(roi_mask[..., None] & gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))
    max_overlaps = iou.max(dim=-1).values  # [B, R]; -1 for invalid rois
    gt_assignment = iou.argmax(dim=-1)
    roi_labels = torch.gather(gt_labels.long(), 1, gt_assignment)

    fg_cand = max_overlaps >= pos_iou_threshold
    bg_cand = (max_overlaps < pos_iou_threshold) & (max_overlaps >= neg_iou_threshold)

    # fg: keep <= max_pos_samples, their indices in a fixed prefix
    k_fg = min(max_pos_samples, r)
    fg_vals, fg_idx = _top(_neg_inf_where_not(fg_cand, fg_priority), k_fg)
    fg_valid = fg_vals > neg_inf
    num_fg = fg_valid.sum(dim=-1, keepdim=True)  # [B, 1]
    if strict_class_column:
        # ascending roi order of the selected set, invalid slots last
        fg_idx = torch.sort(torch.where(fg_valid, fg_idx, torch.full_like(fg_idx, r)), dim=-1).values
        fg_idx = fg_idx.clamp_max(r - 1)

    # bg without replacement when there are enough ...
    num_bg_needed = s - num_fg
    bg_scores = _neg_inf_where_not(bg_cand, bg_priority)
    bg_vals_wor, bg_idx_wor = _top(bg_scores, min(s, r))
    if strict_class_column:
        # the selected bg set in ascending roi order
        nb = num_bg_needed.clamp(1, bg_vals_wor.shape[-1])
        kth = torch.gather(bg_vals_wor, 1, nb - 1)
        selected_bg = bg_cand & (bg_scores >= kth)
        asc = -torch.arange(r, dtype=torch.float32, device=dev).expand(bsz, r)
        _, bg_idx_wor = _top(_neg_inf_where_not(selected_bg, asc), min(s, r))
    if bg_idx_wor.shape[-1] < s:  # fewer rois than slots: tile the indices
        reps = -(-s // bg_idx_wor.shape[-1])
        bg_idx_wor = bg_idx_wor.repeat(1, reps)[:, :s]
    num_bg_avail = bg_cand.sum(dim=-1, keepdim=True)

    # ... and with replacement when scarce; with no bg candidate at all, any
    # valid roi (the reference would fail on an empty set)
    zeros = torch.zeros_like(bg_scores)
    ninf = torch.full_like(bg_scores, neg_inf)
    bg_logits = torch.where(bg_cand, zeros, ninf)
    bg_logits = torch.where(num_bg_avail > 0, bg_logits, torch.where(roi_mask, zeros, ninf))
    bg_idx_wr = (bg_gumbel + bg_logits[:, None, :]).argmax(dim=-1)  # [B, S]

    # without replacement also when bg exactly fills the quota
    use_wor = num_bg_avail >= num_bg_needed
    bg_idx_all = torch.where(use_wor, bg_idx_wor, bg_idx_wr)  # [B, S]

    slot = torch.arange(s, device=dev).expand(bsz, s)
    is_fg_slot = slot < num_fg
    fg_slot_idx = torch.gather(fg_idx, 1, slot.clamp_max(k_fg - 1))
    bg_slot_idx = torch.gather(bg_idx_all, 1, (slot - num_fg).clamp_min(0))
    src = torch.where(is_fg_slot, fg_slot_idx, bg_slot_idx)  # [B, S] roi indices

    out_rois = torch.gather(rois, 1, src[..., None].expand(-1, -1, 4))
    zero_labels = torch.zeros_like(src)
    out_labels = torch.where(is_fg_slot, torch.gather(roi_labels, 1, src), zero_labels)

    matched = torch.gather(gt_assignment, 1, src)
    matched_gt = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    enc = encode_boxes(out_rois, matched_gt, target_means, target_stds)  # [B, S, 4]
    if strict_class_column:
        # the reference writes fg slot i at the class column of the i-th roi
        # in proposal order, not at the selected roi's own label
        col_labels = torch.where(is_fg_slot, torch.gather(roi_labels, 1, slot.clamp_max(r - 1)),
                                 zero_labels)
    else:
        col_labels = out_labels
    onehot = torch.nn.functional.one_hot(col_labels, num_classes).float()  # [B, S, C]
    fg_f = is_fg_slot.float()[..., None, None]
    bbox_targets = onehot[..., None] * enc[..., None, :] * fg_f
    in_weights = onehot[..., None] * torch.ones(4, device=dev) * fg_f
    out_weights = torch.ones_like(in_weights)

    valid = roi_mask.any(dim=-1, keepdim=True).expand(bsz, s)
    flat = (bsz, s, num_classes * 4)
    return ProposalTargets(out_rois, out_labels, bbox_targets.reshape(flat),
                           in_weights.reshape(flat), out_weights.reshape(flat), valid)
