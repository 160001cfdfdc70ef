"""A result that several test workers share, computed once per session.

Under pytest-xdist every worker imports every test module, so a
module-scoped fixture runs once in each worker that draws one of its
tests. `shared` keeps the first worker's result in the session's common
temporary directory, under a file lock, and hands it to the others.
Importing this module also sizes torch's thread pool to the worker's share
of the cores (`_share_the_cores`).
"""

import ctypes
import gc
import os
import pickle
from contextlib import nullcontext

import numpy as np

try:
    from filelock import FileLock
except ImportError:  # pragma: no cover - then each worker computes its own
    FileLock = None


def _share_the_cores():
    """Under pytest-xdist, torch's intra-op threads of each worker get the
    worker's share of the machine's cores. By default every worker starts
    one thread per core, and N workers then run N times as many threads as
    there are cores, which mostly wait on each other. Every worker imports
    every test module, this one included, so each applies it before its
    first test."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


_share_the_cores()


def _release_freed_memory():
    """Hand the heap the last computation freed back to the system (glibc
    keeps it otherwise, and an xdist worker's size only grows): a large
    comparison (VGG16's 138 M parameters, their gradients and traces in both
    frameworks) leaves several GB freed in the worker that ran it."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass


def shared(tmp_path_factory, name, compute):
    """compute() once for the session (a picklable value), by name."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with FileLock(str(path) + ".lock") if FileLock else nullcontext():
        if path.is_file():
            return pickle.loads(path.read_bytes())
        value = compute()
        _release_freed_memory()
        path.write_bytes(pickle.dumps(value))
        return value


def jax_init(tmp_path_factory, model_type, rpn_score_scale):
    """The flat JAX `init_params(PRNGKey(0))` of ResNet-50 `model_type` with
    its RPN score layer scaled by `rpn_score_scale` (so that random-weight
    proposals separate), once per session. The values depend only on the
    parameter shapes, which the test files' configs share (21 classes, 9
    anchors, 256 FPN dims)."""

    def compute():
        import jax
        import numpy as np
        from flax.traverse_util import flatten_dict

        from tf_eager_object_detection_tpu.config.config_factory import config_factory
        from tf_eager_object_detection_tpu.models.model_factory import model_factory

        jdet = model_factory(model_type, "resnet50", dict(config_factory("pascal", model_type)))
        flat = {k: np.array(v) for k, v in
                flatten_dict(jdet.init_params(jax.random.PRNGKey(0)), sep="/").items()}
        flat["rpn_head/rpn_score_conv/kernel"] *= rpn_score_scale
        return flat

    return shared(tmp_path_factory, f"jax_init_{model_type}_rpn_x{rpn_score_scale:g}", compute)


def numpy_params(jax_detector, seed, residual_gain=0.2):
    """Seeded weights for a JAX detector's parameter tree, flat, made with
    numpy from the shapes of its `init_params` (`jax.eval_shape`, no JAX
    init to run): conv and dense kernels lecun-normal, small random biases,
    and random frozen-BatchNorm statistics. Each bottleneck's last BatchNorm
    scales by `residual_gain`, so that the residual stream stays of the
    order of its input through the 50 blocks of ResNet-152 (with unit
    gains it grows by a factor of ~2 a block)."""
    import jax
    from flax.traverse_util import flatten_dict

    shapes = flatten_dict(jax.eval_shape(jax_detector.init_params, jax.random.PRNGKey(0)),
                          sep="/")
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(shapes.items()):
        scope, name = path.rsplit("/", 1)
        shape = tuple(leaf.shape)
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            value = rng.standard_normal(shape, dtype=np.float32) * std
        elif name in ("bias", "beta", "moving_mean"):
            value = rng.standard_normal(shape, dtype=np.float32) * 0.1
        elif name == "moving_variance":
            value = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name == "gamma":
            gain = residual_gain if scope.endswith("_3_bn") else 1.0
            value = rng.uniform(0.8, 1.2, shape).astype(np.float32) * gain
        else:
            raise ValueError(f"unknown leaf {path}")
        out[path] = value
    return out
