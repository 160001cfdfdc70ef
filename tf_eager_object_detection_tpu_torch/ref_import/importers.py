"""Checkpoint importers: keras .h5 / slim-TF checkpoint / raw dict -> a detector
(port of `tf_eager_object_detection_tpu/ref_import/importers.py`).

The importers work on a detector's weights in the flax layout, as the JAX
ones do: `params_tree(detector)` is the nested numpy tree
`{module: {layer: {leaf: ndarray}}}` of `from_jax.flat_params_from_state_dict`
(conv kernels HWIO, dense kernels [in, out], FrozenBatchNorm statistics as
leaves), the importers return a filled copy of it, and `load_params_tree`
loads that copy into the detector through `from_jax.load_jax_params`, whose
key and shape checks run before the detector is touched. So a checkpoint
tensor lands exactly where the JAX importer puts it, the flax-layout
operations (the conv1 BGR flip, the fc6 reshape) stay the JAX ones, and a
failed import leaves the detector as it was.

- `apply_name_map`: a {prefix: (module, layer)} map of `name_maps` over a
  flat {checkpoint name: array} dict: FrozenBatchNorm groups (the layers
  with a `gamma`) take prefix + gamma / beta / moving_mean /
  moving_variance; other layers prefix + weights / biases, a missing
  `biases` filling the bias with zeros (slim convs have none,
  resnet_faster_rcnn.py:385-388); `bgr_flip_layers` reverse the input
  channels of a conv kernel (vgg16_faster_rcnn.py:378-383); a tensor of
  another shape but the same size is reshaped (slim fc6 [7, 7, 512, 4096]
  -> Dense [25088, 4096]).
- `load_tf_checkpoint_dict`: a TF checkpoint -> {name: ndarray}; needs
  tensorflow and raises ImportError without it.
- `load_keras_h5`: a keras-applications `.h5` by layer name (keras
  `by_name=True`); needs h5py and raises ImportError naming it without.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Tuple

import numpy as np

from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    flat_params_from_state_dict,
    load_jax_params,
)

__all__ = [
    "params_tree",
    "load_params_tree",
    "apply_name_map",
    "load_tf_checkpoint_dict",
    "load_keras_h5",
]

_BN_SUFFIXES = ("gamma", "beta", "moving_mean", "moving_variance")
# keras dataset-name suffixes of each flax leaf; the old VGG16 files name
# their datasets `{layer}_W_1:0` / `{layer}_b_1:0`
_KERAS_SUFFIXES = {
    "kernel": ("kernel:0", "W:0", "W_1:0"),
    "bias": ("bias:0", "b:0", "b_1:0"),
    "gamma": ("gamma:0",),
    "beta": ("beta:0",),
    "moving_mean": ("moving_mean:0",),
    "moving_variance": ("moving_variance:0",),
}


def params_tree(detector) -> Dict:
    """The detector's weights as the nested flax-layout tree, on the host."""
    tree: Dict = {}
    for path, value in flat_params_from_state_dict(detector.state_dict()).items():
        *scope, leaf = path.split("/")
        node = tree
        for key in scope:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def load_params_tree(detector, tree: Mapping) -> None:
    """Load a (filled) `params_tree` into the detector, in place; raises
    before touching it where a leaf or a shape does not fit."""
    load_jax_params(detector, _flatten(tree))


def _reshape_to(value: np.ndarray, target_shape) -> np.ndarray:
    value = np.asarray(value)
    if tuple(value.shape) == tuple(target_shape):
        return value
    if value.size == int(np.prod(target_shape)):
        # e.g. slim fc6 conv weights [7,7,512,4096] -> Dense [25088, 4096]
        return value.reshape(target_shape)
    raise ValueError(f"shape mismatch: {value.shape} vs {target_shape}")


def apply_name_map(
    params: Dict,
    tensors: Mapping[str, np.ndarray],
    name_map: Mapping[str, Tuple[str, str]],
    bgr_flip_layers: Tuple[Tuple[str, str], ...] = (),
    strict: bool = True,
) -> Dict:
    """Write checkpoint tensors into a copy of a `params_tree`.

    tensors: flat {ckpt_name: array}; name_map: {prefix: (module, layer)}.
    A layer that the tree lacks raises KeyError with `strict`, else is
    skipped; a tensor that the checkpoint lacks raises KeyError.
    """
    params = copy.deepcopy(params)
    for prefix, (module, layer) in name_map.items():
        target = params[module].get(layer)
        if target is None:
            if strict:
                raise KeyError(f"params[{module}] has no layer {layer}")
            continue
        if "gamma" in target:  # FrozenBatchNorm
            for suffix in _BN_SUFFIXES:
                name = prefix + suffix
                if name not in tensors:
                    raise KeyError(f"missing {name}")
                target[suffix] = _reshape_to(tensors[name], target[suffix].shape)
        else:
            wname = prefix + "weights"
            if wname not in tensors:
                raise KeyError(f"missing {wname}")
            kernel = np.asarray(tensors[wname])
            if (module, layer) in bgr_flip_layers:
                kernel = kernel[:, :, ::-1, :]  # HWIO: the input channels
            target["kernel"] = _reshape_to(kernel, target["kernel"].shape)
            if "bias" in target:
                bname = prefix + "biases"
                if bname in tensors:
                    target["bias"] = _reshape_to(tensors[bname], target["bias"].shape)
                else:  # slim convs have no biases -> zeros
                    target["bias"] = np.zeros_like(target["bias"])
    return params


def load_tf_checkpoint_dict(ckpt_path: str) -> Dict[str, np.ndarray]:
    """TF checkpoint -> flat {var_name: ndarray} (needs tensorflow)."""
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:
        raise ImportError(
            "reading TF checkpoints requires tensorflow; alternatively "
            "convert the checkpoint to a pickle/npz dict offline"
        ) from e
    reader = py_checkpoint_reader.NewCheckpointReader(ckpt_path)
    return {name: reader.get_tensor(name) for name in reader.get_variable_to_shape_map()}


def load_keras_h5(params: Dict, h5_path: str, modules: Tuple[str, ...]) -> Dict:
    """Load keras-applications .h5 weights by layer name into a copy of a
    `params_tree`.

    Walks each layer in params[module]; if the h5 file has a group of the
    layer's name, each leaf takes the first dataset, in `visititems` order,
    whose name ends in one of its suffixes. Layers without a group are left
    untouched (keras `by_name=True` semantics).
    """
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading keras .h5 weights requires h5py") from e

    params = copy.deepcopy(params)
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for module in modules:
            for layer, ptree in params[module].items():
                if layer not in root:
                    continue
                datasets: Dict[str, np.ndarray] = {}

                def visit(name, obj):
                    if hasattr(obj, "shape"):
                        datasets[name] = np.asarray(obj)

                root[layer].visititems(visit)
                for pname in list(ptree):
                    suffixes = _KERAS_SUFFIXES[pname]
                    for ds_name, value in datasets.items():
                        if ds_name.endswith(suffixes):
                            ptree[pname] = _reshape_to(value, ptree[pname].shape)
                            break
    return params
