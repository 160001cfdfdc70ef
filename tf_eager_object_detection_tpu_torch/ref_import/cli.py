"""Checkpoint loading for the command-line tools (port of
`tf_eager_object_detection_tpu/ref_import/cli.py::{add_import_flags,
load_checkpoint_params}`, cut to the port's own formats).

`load_checkpoint_params(detector, ckpt, args)` loads, in place:

- a directory of the port's `training/checkpoints.py::CheckpointManager`
  (its latest step);
- a `.npz` in the JAX package's flat `save_params` format, written by
  either package.

Third-party checkpoints (tf-faster-rcnn, FPN_Tensorflow, keras `.h5`) and
every other format raise: their importers are ROADMAP item 9.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["add_import_flags", "load_checkpoint_params"]

_IMPORT_FLAGS = ("use_tf_faster_rcnn_model", "use_fpn_tensorflow_model", "keras_h5")
_NOT_PORTED = "third-party checkpoint importers are not ported yet (ROADMAP item 9)"


def add_import_flags(parser):
    """The JAX tools' import flags; in the port each of them raises."""
    parser.add_argument("--use_tf_faster_rcnn_model", action="store_true",
                        help="CKPT is a tf-faster-rcnn TF checkpoint (not ported: ROADMAP item 9)")
    parser.add_argument("--use_fpn_tensorflow_model", action="store_true",
                        help="CKPT is an FPN_Tensorflow TF checkpoint (not ported: ROADMAP "
                             "item 9)")
    parser.add_argument("--keras_h5", action="store_true",
                        help="CKPT is a keras-applications .h5 file (not ported: ROADMAP item 9)")
    return parser


def load_checkpoint_params(detector, ckpt: str, args=None) -> Optional[str]:
    """Load `ckpt` into `detector` -> the eval image format (None: the
    preprocessing's own channel order)."""
    from tf_eager_object_detection_tpu_torch.training.checkpoints import (
        CheckpointManager,
        load_params,
    )

    flags = [f for f in _IMPORT_FLAGS if getattr(args, f, False)]
    if flags:
        raise NotImplementedError(f"--{flags[0]}: {_NOT_PORTED}")
    if ckpt.endswith(".npz") and os.path.isfile(ckpt):
        load_params(ckpt, detector)
        return None
    if os.path.isdir(ckpt):
        if CheckpointManager(ckpt).restore(detector) is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {ckpt!r} (pass the training --logs_dir or a "
                "params .npz)")
        return None
    raise NotImplementedError(
        f"{ckpt!r} is neither a checkpoint directory of the port nor a params .npz; "
        f"{_NOT_PORTED}")
