"""Data parallelism over a process group (port of `tf_eager_object_detection_tpu/parallel/mesh.py`).

JAX jits the train step with the parameters replicated and the batch
sharded over a device mesh, and XLA inserts the gradient all-reduce. Here
each rank of a `torch.distributed` group (`parallel/multihost.py`) holds
the whole detector on its device and takes its own rows of the global
batch; `DistributedDataParallel` averages the gradients over the group in
the backward, and every rank applies the same update. Frozen parameters
(requires_grad False) stay out of the reduction, and the frozen
BatchNorms' buffers are not broadcast after the first synchronisation.

As in JAX, the global batch shares one set of random numbers: a step
takes the global batch's `TrainDraws` (or samples them from a generator
that every rank seeds alike) and keeps its rows (`TrainDraws.rows`). A
step of N ranks at b images each is then the single-device step at
B = N * b: `_detection_loss` averages the RPN losses over the images and
the RoI losses over B * S rows with S fixed, so the mean of the ranks'
gradients is the gradient of the global batch's loss when every rank has
the same number of rows, which the step checks against the draws.

Eval: `replicate(detector, devices)` gives one detector per device with
the first one's weights, and `eval_devices(device, n)` the first n devices
of a detector's type (`evaluation/batched_inference.py`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws

__all__ = ["make_parallel_train_step", "replicate", "eval_devices", "check_eval_data_parallel"]


class _Loss(nn.Module):
    """The detector's training loss as a module, for DDP to wrap: its
    forward is `loss_fn`, so DDP arms the gradient reduction on it."""

    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, images, image_hw, gt_boxes, gt_mask, gt_labels, draws):
        return self.detector.loss_fn(images, image_hw, gt_boxes, gt_mask, gt_labels, draws)


def make_parallel_train_step(detector, optimizer, process_group=None, batch_shard=None):
    """-> step(batch, draws=None) -> metrics, the data-parallel
    `training/train_step.py::make_train_step`.

    batch = this rank's rows (images, image_hw, gt_boxes, gt_mask,
    gt_labels), b images; `draws` is the global batch's `TrainDraws` (N * b
    images), or a `torch.Generator` to sample them from, or None for the
    detector's own generator. `batch_shard` = (index, N): this rank's rows
    are the index-th of the N equal shares of the global batch (default:
    the rank and the size of `process_group`; `parallel/spatial.py` gives
    the sp ranks of a batch group one index). The metrics are this rank's;
    averaging them over the ranks is the caller's (the trainer does so
    where it reads them). Building the step broadcasts rank 0's parameters
    and buffers to every rank of `process_group` (default: the default
    group)."""
    group = process_group if process_group is not None else dist.group.WORLD
    rank, world = batch_shard or (dist.get_rank(group), dist.get_world_size(group))
    device = detector.device
    ddp = DistributedDataParallel(
        _Loss(detector),
        device_ids=[_canonical(device)] if device.type == "cuda" else None,
        process_group=process_group,
        broadcast_buffers=False,
    )
    num_samples = detector.cfg["roi_total_sample_number"]

    def step(batch, draws=None):
        b = int(batch[0].shape[0])
        if not isinstance(draws, TrainDraws):
            draws = detector.sample_draws(detector.generator if draws is None else draws,
                                          world * b, tuple(batch[0].shape[1:3]))
        elif draws.anchor_fg.shape[0] != world * b:
            raise ValueError(f"draws for {draws.anchor_fg.shape[0]} images, but {world} ranks "
                             f"of {b} images each make {world * b}: the gradient mean needs "
                             "equal rows on every rank")
        optimizer.zero_grad()
        total, metrics = ddp(*batch, draws.rows(rank * b, (rank + 1) * b, num_samples))
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    step.ddp = ddp
    return step


def eval_devices(device, n: int) -> List[torch.device]:
    """The first n devices of `device`'s type: cuda:0 .. cuda:n-1, refused
    beyond `torch.cuda.device_count()`; the CPU n times."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"data_parallel={n} needs {n} CUDA devices, this machine has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def check_eval_data_parallel(batch_size: int, data_parallel: int, device=None) -> None:
    """Refuse an eval `data_parallel` that does not split `batch_size` into
    equal shards, or, given the detector's `device`, that asks for more
    CUDA devices than there are."""
    if data_parallel < 0:
        raise ValueError(f"data_parallel={data_parallel} < 0")
    if data_parallel and batch_size % data_parallel:
        raise ValueError(f"batch_size={batch_size} not divisible by data_parallel={data_parallel}")
    if data_parallel and device is not None:
        eval_devices(device, data_parallel)


def _canonical(device) -> torch.device:
    """`device` with its index: CUDA without one is the current device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(detector, devices) -> list:
    """One detector per device of `devices` with `detector`'s weights (its
    `state_dict`, buffers included): `detector` itself where it already
    lies on the first device, new ones of the same type, backbone and
    config elsewhere."""
    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory

    state: Optional[dict] = None
    replicas = []
    for i, dev in enumerate(devices):
        dev = _canonical(dev)
        if i == 0 and dev == _canonical(detector.device):
            replicas.append(detector)
            continue
        if state is None:
            state = detector.state_dict()
        rep = model_factory(detector.model_type, detector.backbone_name, detector.cfg,
                            device=dev)
        rep.load_state_dict(state)
        replicas.append(rep)
    return replicas
