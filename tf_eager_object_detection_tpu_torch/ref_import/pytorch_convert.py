"""PyTorch weight conversion (port of
`tf_eager_object_detection_tpu/ref_import/pytorch_convert.py`; reference U6,
`object_detection/utils/pytorch_to_tf.py:5-23`): OIHW conv kernels -> HWIO,
2-D fc weights transposed; `.pth` -> pickled {name: ndarray} dict in the TF
layouts. Needs neither tensorflow nor h5py.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

__all__ = ["pytorch_to_jax_np", "convert_pth_to_dict", "load_pickle_dict"]


def pytorch_to_jax_np(value: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO for 4-D tensors; transpose for 2-D (torch fc is [out, in])."""
    value = np.asarray(value)
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    if value.ndim == 2:
        return value.transpose(1, 0)
    return value


def convert_pth_to_dict(pth_file_path: str, dict_file_path: str) -> Dict[str, np.ndarray]:
    """Load a .pth state dict on the CPU -> pickled numpy dict."""
    state = torch.load(pth_file_path, map_location="cpu")
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out = {
        k: pytorch_to_jax_np(v.detach().numpy())
        for k, v in state.items()
        if hasattr(v, "detach")
    }
    with open(dict_file_path, "wb") as f:
        pickle.dump(out, f)
    return out


def load_pickle_dict(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)
