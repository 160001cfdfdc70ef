"""Train step (port of `tf_eager_object_detection_tpu/training/train_step.py`).

One step is the loss, its gradients and the optimizer update; frozen
parameters take no gradient (`models/freeze.py`). Nothing is read back to
the host: the returned metrics stay tensors until the caller reads them.
"""

from __future__ import annotations

import torch

__all__ = ["make_train_step"]


def make_train_step(detector, optimizer, with_probe: bool = False):
    """-> step(batch, draws=None) -> metrics.

    batch = (images, image_hw, gt_boxes, gt_mask, gt_labels), numpy or
    tensors; `draws` is a `TrainDraws`, a `torch.Generator` to draw them
    from, or None for the detector's own generator (see `loss_fn`).

    with_probe=True adds `probe`, the sum of every entry of the detector's
    state_dict after the update (the parameters and the FrozenBatchNorm
    statistics: the leaves of the JAX parameter tree), a 0-dim tensor on
    the device that depends on the whole update; reading it waits for the
    step. The default keeps the metrics to the reference's loss series.
    """

    def step(batch, draws=None):
        images, image_hw, gt_boxes, gt_mask, gt_labels = batch
        optimizer.zero_grad()
        total, metrics = detector.loss_fn(images, image_hw, gt_boxes, gt_mask, gt_labels, draws)
        total.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if with_probe:
            with torch.no_grad():
                metrics["probe"] = torch.stack(
                    [t.sum() for t in detector.state_dict().values()]).sum()
        return metrics

    return step
