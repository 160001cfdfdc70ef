"""Train step (port of `tf_eager_object_detection_tpu/training/train_step.py`).

One step is the loss, its gradients and the optimizer update; frozen
parameters take no gradient (`models/freeze.py`). Nothing is read back to
the host: the returned metrics stay tensors until the caller reads them.
"""

from __future__ import annotations

__all__ = ["make_train_step"]


def make_train_step(detector, optimizer):
    """-> step(batch, draws=None) -> metrics.

    batch = (images, image_hw, gt_boxes, gt_mask, gt_labels), numpy or
    tensors; `draws` is a `TrainDraws`, a `torch.Generator` to draw them
    from, or None for the detector's own generator (see `loss_fn`).
    """

    def step(batch, draws=None):
        images, image_hw, gt_boxes, gt_mask, gt_labels = batch
        optimizer.zero_grad()
        total, metrics = detector.loss_fn(images, image_hw, gt_boxes, gt_mask, gt_labels, draws)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
