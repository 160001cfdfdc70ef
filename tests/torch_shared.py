"""A result that several test workers share, computed once per session.

Under pytest-xdist every worker imports every test module, so a
module-scoped fixture runs once in each worker that draws one of its
tests. `shared` keeps the first worker's result in the session's common
temporary directory, under a file lock, and hands it to the others.
"""

import os
import pickle
from contextlib import nullcontext

try:
    from filelock import FileLock
except ImportError:  # pragma: no cover - then each worker computes its own
    FileLock = None


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
