"""Weight bridge: flax parameters of the JAX package -> this port's state_dict.

Input is the flat `{"extractor/conv1_conv/kernel": ndarray, ...}` mapping
that `tf_eager_object_detection_tpu/training/checkpoints.py::save_params`
writes to `.npz` (flax `flatten_dict(sep="/")`). Read with numpy alone.

- conv kernels HWIO -> OIHW `weight`; dense kernels [in, out] -> [out, in];
- `bias` as it is;
- FrozenBatchNorm `gamma`/`beta`/`moving_mean`/`moving_variance` -> buffers
  of the same names.

Any leaf that the port has no slot for, or any slot that no leaf fills,
raises. Trees shaped like the parameters (gradients, momentum traces) cross
with the same layout rules (`parameter_tree_from_jax`), without the
BatchNorm leaves: in the port those are frozen buffers, with no gradient
and no trace.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["read_flat_params", "state_dict_from_jax", "load_jax_params",
           "parameter_tree_from_jax"]

_BN_LEAVES = ("gamma", "beta", "moving_mean", "moving_variance")


def read_flat_params(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Flat {"a/b/leaf": ndarray} from a `save_params` .npz file."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _convert_leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    *scope, leaf = path.split("/")
    name = ".".join(scope)
    if leaf == "kernel":
        if value.ndim == 4:
            return f"{name}.weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return f"{name}.weight", value.T
        raise ValueError(f"{path}: kernel of rank {value.ndim}")
    if leaf == "bias" or leaf in _BN_LEAVES:
        return f"{name}.{leaf}", value
    raise ValueError(f"{path}: unknown flax leaf {leaf!r}")


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Convert a flat flax parameter mapping to torch tensors under port names."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        name, converted = _convert_leaf(path, np.asarray(value))
        out[name] = torch.from_numpy(np.array(converted, dtype=np.float32, order="C"))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray] | str | os.PathLike) -> None:
    """Load flat flax params (a mapping or a `save_params` .npz path) into `model`.

    Every leaf must be consumed exactly once and every state_dict entry
    filled, with matching shapes; otherwise raises before touching `model`.
    """
    flat = params if isinstance(params, Mapping) else read_flat_params(params)
    converted = state_dict_from_jax(flat)
    expected = model.state_dict()
    unused = sorted(converted.keys() - expected.keys())
    missing = sorted(expected.keys() - converted.keys())
    if unused or missing:
        raise KeyError(f"weight bridge mismatch: unused {unused[:8]}, missing {missing[:8]}")
    for name, tensor in converted.items():
        if tuple(tensor.shape) != tuple(expected[name].shape):
            raise ValueError(
                f"{name}: shape {tuple(tensor.shape)} from JAX, "
                f"{tuple(expected[name].shape)} in the port"
            )
    model.load_state_dict(converted, strict=True)


def parameter_tree_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A flat flax tree shaped like the parameters (gradients, momentum
    traces) -> {port parameter name: tensor}, BatchNorm leaves dropped."""
    return state_dict_from_jax(
        {k: v for k, v in flat.items() if k.rsplit("/", 1)[-1] not in _BN_LEAVES}
    )
