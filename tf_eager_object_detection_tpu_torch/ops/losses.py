"""Detection losses (port of `tf_eager_object_detection_tpu/ops/losses.py`).

Mask-aware, as in JAX: `cls_loss` is the mean softmax cross entropy over the
rows a weight selects, `smooth_l1_loss` the smooth-L1 with inside and
outside weights. Both reduce over the last dimensions they name and keep any
leading ones, so a batch of images gives one loss per image.
"""

from __future__ import annotations

import torch

__all__ = ["cls_loss", "smooth_l1_loss"]


def cls_loss(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Sparse softmax cross entropy averaged over the rows with weight > 0.

    logits [..., N, C]; labels [..., N] int (negative labels are masked rows);
    weights [..., N] float or bool, or None for a plain mean. Returns [...].
    """
    labels = labels.clamp_min(0)
    log_p = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_p, -1, labels.unsqueeze(-1).long()).squeeze(-1)
    if weights is None:
        return nll.mean(dim=-1)
    w = weights.float()
    return (nll * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)


def smooth_l1_loss(
    bbox_pred: torch.Tensor,
    bbox_targets: torch.Tensor,
    in_weights: torch.Tensor,
    out_weights: torch.Tensor,
    sigma: float = 1.0,
    dim=(1,),
) -> torch.Tensor:
    """Smooth-L1 with inside/outside weights: sum over `dim`, then the mean
    over the remaining dimensions (the RPN takes sigma 3 and the per-image
    dims (0, 1), the RoI head sigma 1 and dim (1,))."""
    sigma_2 = sigma**2
    diff = in_weights * (bbox_pred - bbox_targets)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).float()
    per_elem = diff.square() * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    return (out_weights * per_elem).sum(dim=tuple(dim)).mean()
