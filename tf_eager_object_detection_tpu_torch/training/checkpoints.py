"""Checkpoints (port of `tf_eager_object_detection_tpu/training/checkpoints.py`).

A `CheckpointManager` keeps the training state of a detector and its
optimizer (`training/optimizer.py`: momentum or Adam) in a directory, one
`torch.save` file a step:

    {"params": detector.state_dict(),
     "opt_state": {"<slot>/<parameter name>": tensor, ...},  # trace/..., or mu/... and nu/...
     "step": optimizer.count}

every tensor on the CPU, so a checkpoint written on the card restores on
the CPU and back. It keeps the `max_to_keep` newest steps; a save at a step
that is already saved does nothing (the epoch-end save right after an
interval save). Restore precedence, as the trainer applies it: an explicit
checkpoint directory, else the latest step in the training directory.

With `distributed=True` (the ranks of a data-parallel process group, whose
states are equal), rank 0 writes and every rank then waits at a barrier,
so that no rank reads a step before it is whole; a restore waits at a
barrier, then every rank loads the step that rank 0 chose, optimizer state
included (DistributedDataParallel broadcasts parameters and buffers, not
the momentum traces).

`save_params` / `load_params` write and read parameters alone in the JAX
package's flat `.npz` format (`"scope/.../kernel"` keys, flax layouts), so
the JAX `load_params` reads what the port saved and the port reads what the
JAX `save_params` wrote.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np
import torch

from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    flat_params_from_state_dict,
    load_jax_params,
)

__all__ = ["CheckpointManager", "save_params", "load_params"]

_FILE_RE = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Training-state checkpoints in `directory`, keyed by step."""

    def __init__(self, directory: str, max_to_keep: int = 5, distributed: bool = False):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.distributed = distributed

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE_RE.match, os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, detector, optimizer) -> None:
        if not self.distributed or torch.distributed.get_rank() == 0:
            self._write(detector, optimizer)
        if self.distributed:
            torch.distributed.barrier()

    def _write(self, detector, optimizer) -> None:
        step = optimizer.count
        if step in self.all_steps():
            return
        state = {
            "params": {k: v.detach().cpu() for k, v in detector.state_dict().items()},
            "opt_state": {f"{slot}/{name}": t.detach().cpu()
                          for slot, tensors in optimizer.state_dict().items() if slot != "count"
                          for name, t in tensors.items()},
            "step": step,
        }
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, detector, optimizer=None, step: Optional[int] = None) -> Optional[int]:
        """Load `step` (default: the latest) into `detector` and, if given,
        `optimizer`; returns the step restored, or None where the directory
        holds no checkpoint (nothing is changed then)."""
        step = step if step is not None else self.latest_step()
        if self.distributed:
            torch.distributed.barrier()
            chosen = [step]
            torch.distributed.broadcast_object_list(chosen, src=0)
            step = chosen[0]
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        detector.load_state_dict(state["params"], strict=True)
        if optimizer is not None:
            slots = {slot: {} for slot in optimizer.state_dict() if slot != "count"}
            for key, t in state["opt_state"].items():
                slot, name = key.split("/", 1)
                slots.setdefault(slot, {})[name] = t
            optimizer.load_state_dict({**slots, "count": state["step"]})
        return int(state["step"])

    def close(self) -> None:
        """Nothing runs in the background; kept for the JAX API."""


def save_params(path: str, detector) -> None:
    """The detector's parameters alone, as the JAX `save_params` .npz."""
    flat = flat_params_from_state_dict(detector.state_dict())
    np.savez(path, **flat)


def load_params(path: str, detector) -> None:
    """Parameters from a JAX-format .npz (`save_params` of either package)
    into `detector`, in place."""
    load_jax_params(detector, path)
