"""Bucket-grouped batched eval inference
(port of `tf_eager_object_detection_tpu/evaluation/batched_inference.py`).

Groups the stream by padded bucket shape and flushes bucket-uniform batches
through `detector.im_detect_batch`, so the backbone and the RPN NMS run once
per batch. Results are yielded per image.

`data_parallel=N` splits each flushed batch into N equal shards, one a
replica of the detector (`parallel/mesh.py::replicate`) on the first N
devices of its type (cuda:0 .. cuda:N-1; the CPU N times), or on
`devices` where given (`[cpu, cpu]`, or `[cuda:0, cuda:0]` on a machine
with one GPU). The host issues the shards one after another; the work of
replicas on different GPUs overlaps on the devices, as the launches are
asynchronous. Each image's outputs stay on its replica's device. A
`batch_size` that N does not divide is refused, and so is an N above
`torch.cuda.device_count()` for CUDA.

`spatial_partition=N` > 1 (exclusive with `data_parallel`) shards each
image's rows over the N ranks of the default process group, all of them
(`parallel/spatial.py`; JAX's ("batch" = 1, "space" = N) mesh): every rank
reads the same stream and flushes the same batches, takes its rows of each
image, and gets every image's outputs. An N other than the world size is
refused, and so is an image height that N does not divide, on every rank,
before the batch's first collective.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["batched_im_detect"]


def batched_im_detect(
    detector, items: Iterable, batch_size: int = 8, data_parallel: int = 0,
    devices: Optional[Sequence] = None, spatial_partition: int = 0,
) -> Iterator[Tuple[int, tuple, tuple]]:
    """Yields (stream_index, item, (softmax, deltas, rois, roi_valid)).

    `items` yields host-side tuples whose first three entries are
    (padded_image [Hp, Wp, 3], image_hw [2], scale); further entries ride
    along untouched. A final partial batch is padded by repeating its last
    element, and padded rows are dropped before yielding. Yield order is
    batch-completion order, NOT stream order: index by `stream_index`.
    The arguments are checked, and the replicas or the space group made,
    at the call.
    """
    if data_parallel and spatial_partition:
        raise ValueError("data_parallel and spatial_partition are exclusive")
    if spatial_partition > 1:
        from tf_eager_object_detection_tpu_torch.parallel.spatial import (
            make_spatial_groups,
            make_spatial_im_detect_batch,
        )

        groups = make_spatial_groups(spatial_partition)
        if groups.dp != 1:
            raise ValueError(f"spatial eval shards each image over every rank: "
                             f"spatial_partition={spatial_partition} must equal the world size "
                             f"{groups.dp * groups.sp}")
        return _batches([(None, make_spatial_im_detect_batch(detector, groups))], items,
                        batch_size)
    if data_parallel:
        from tf_eager_object_detection_tpu_torch.parallel.mesh import (
            check_eval_data_parallel,
            eval_devices,
            replicate,
        )

        check_eval_data_parallel(batch_size, data_parallel,
                                 detector.device if devices is None else None)
        devices = eval_devices(detector.device, data_parallel) if devices is None else devices
        if len(devices) != data_parallel:
            raise ValueError(f"data_parallel={data_parallel} with {len(devices)} devices")
        return _batches([(rep.device, rep.im_detect_batch)
                         for rep in replicate(detector, devices)], items, batch_size)
    return _batches([(None, detector.im_detect_batch)], items, batch_size)


def _batches(replicas, items, batch_size):
    """`replicas`: (device, im_detect_batch) of each shard of a batch (the
    device is read only where there are several shards)."""
    shard = batch_size // len(replicas)

    def flush(group):
        padded = [it for _, it in group]
        padded += [padded[-1]] * (batch_size - len(padded))
        images = np.stack([it[0] for it in padded])
        hws = np.stack([it[1] for it in padded])
        scales = np.asarray([it[2] for it in padded], np.float32)
        if len(replicas) == 1:
            outs = [replicas[0][1](images, hws, scales)]
        else:
            outs = []
            for r, (device, im_detect_batch) in enumerate(replicas):
                rows = slice(r * shard, (r + 1) * shard)
                with _on(device):
                    outs.append(im_detect_batch(images[rows], hws[rows], scales[rows]))
        for i, (idx, item) in enumerate(group):
            yield idx, item, tuple(t[i % shard] for t in outs[i // shard])

    pending: dict = {}
    for idx, item in enumerate(items):
        key = tuple(item[0].shape[:2])
        pending.setdefault(key, []).append((idx, item))
        if len(pending[key]) == batch_size:
            yield from flush(pending.pop(key))
    for group in pending.values():
        yield from flush(group)


def _on(device):
    """The replica's device as the current CUDA device for its shard."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()
