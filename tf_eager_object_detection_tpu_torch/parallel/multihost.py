"""Joining a process group of data-parallel ranks
(port of `tf_eager_object_detection_tpu/parallel/multihost.py`).

JAX joins a `jax.distributed` runtime and builds one mesh over every
process's devices. Here each process is one rank of a `torch.distributed`
process group and drives one device; `parallel/mesh.py` averages the
gradients over the group.

- `initialize(...)`: join the group: over `tcp://<coordinator_address>`
  with the process count and this process's rank, over an `init_method`
  (such as a `file://` store) with both, from torchrun's environment
  (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT: the counterpart of JAX's
  auto-detection), or, with none of these, as the only rank of a group of
  one. The backend is NCCL for a CUDA device and gloo for the CPU unless
  `backend` names one, and every collective of the group times out after
  `timeout_s`.
- `local_device(device)`: this rank's device: `cuda:LOCAL_RANK` for a
  CUDA device without an index (made the current device), else `device`.
- `local_batch_slice(global_batch, rank, world)`: the [start, stop) rows of
  the global batch this rank loads, contiguous by rank; a global batch
  that the world size does not divide is refused.
- `rank_and_world()`, `is_primary()` (rank 0, or no group), `shutdown()`.

Every rank builds the same global batch stream from the same seed and
loads only its own rows, as in JAX.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tf_eager_object_detection_tpu_torch.models.detector import resolve_device

__all__ = ["initialize", "local_device", "local_batch_slice", "rank_and_world", "is_primary",
           "shutdown", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device="cuda",
    init_method: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the default process group -> (rank, world size).

    `coordinator_address` is host:port of rank 0 (it listens there);
    `init_method` a URL that `torch.distributed` reads instead (a
    `file://` store binds no port). Either needs `num_processes` and
    `process_id`. Without both, torchrun's environment where it is set,
    else a group of one process. `device` ("cuda", "cuda:1", "cpu") picks
    the default backend."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; call shutdown() first")
    if coordinator_address is not None and init_method is not None:
        raise ValueError("give coordinator_address or init_method, not both")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    options = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":  # NCCL binds its communicator to this rank's device
        index = device.index if device.index is not None else torch.cuda.current_device()
        options["device_id"] = torch.device("cuda", index)
    url = f"tcp://{coordinator_address}" if coordinator_address is not None else init_method
    if url is not None:
        if num_processes is None or process_id is None:
            raise ValueError(f"joining over {url} needs num_processes and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, **options)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **options)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                **options)
    return rank_and_world()


def local_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    `cuda:LOCAL_RANK` (0 without torchrun's LOCAL_RANK) and the current
    device; anything else is returned as it is. Raises where CUDA is asked
    for and absent."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    return device


def local_batch_slice(global_batch: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) rows of the global batch that `rank` of `world` loads."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world}")
    per_rank = global_batch // world
    return rank * per_rank, (rank + 1) * per_rank


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on rank 0, and where no process group is initialized."""
    return rank_and_world()[0] == 0


def shutdown() -> None:
    """Leave the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
