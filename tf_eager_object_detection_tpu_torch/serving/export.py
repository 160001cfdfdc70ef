"""Serving export: `predict` as one `torch.export` program per image bucket
(port of `tf_eager_object_detection_tpu/serving/export.py`).

The JAX package serializes jitted `predict` to StableHLO that runs on the
JAX runtime. Its counterpart here is a serialized `ExportedProgram`
(`torch.export.save`, `.pt2`) that runs on PyTorch with the port's operator
library registered (`ops/kernels/library.py`; `load_predict` imports it):
the program calls K1 and, for FPN, K4 as `tf_eager_od` operators, whose
CUDA kernels build from `csrc/` on their first call. A program is traced
on the detector's device and runs there; the model code and the checkpoint
are not needed to serve it.

Layout of an export directory:

    meta.json               {format_version, model_type, backbone,
                             num_classes, buckets, platforms, params_baked}
    predict_{H}x{W}.pt2     one ExportedProgram per config bucket
    params.npz              bake_params=False only: the weights, once, in
                            the JAX package's flat layout

`load_predict` reloads the programs and returns a callable that dispatches
on the padded image shape and re-wraps the output as `Detections`.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.models.detector import PredictProgram, resolve_device
from tf_eager_object_detection_tpu_torch.ops.kernels import library  # noqa: F401  (the operators)
from tf_eager_object_detection_tpu_torch.ops.prediction import Detections
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    read_flat_params,
    state_dict_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params

__all__ = ["export_predict", "load_predict"]

_FORMAT_VERSION = 1


class _ParamsAsInputs(nn.Module):
    """`PredictProgram` with the detector's parameters and buffers as call
    inputs: forward(params {state_dict name: tensor}, image, image_hw). The
    program is held outside the module's tree, so that none of its tensors
    is saved with the export."""

    def __init__(self, program: PredictProgram):
        super().__init__()
        self._program = (program,)

    def forward(self, params, image, image_hw):
        program = self._program[0]
        return torch.func.functional_call(
            program, {f"detector.{k}": v for k, v in params.items()}, (image, image_hw),
            strict=True)


def _bucket_path(export_dir: str, h: int, w: int) -> str:
    return os.path.join(export_dir, f"predict_{h}x{w}.pt2")


def _save(program, path: str) -> None:
    """`torch.export.save` with the archive's records that halve under
    deflate (the graph's JSON, some tens of bytes a node) deflated and the
    rest (tensor payloads) stored as they are: `torch.export.load` reads
    both. Judged by content, not by record name, which differ between
    PyTorch versions."""
    program.example_inputs = None  # else saved too: the weights, for bake_params=False
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(buf) as src, zipfile.ZipFile(path, "w") as dst:
        for info in src.infolist():
            data = src.read(info)
            head = data[:1 << 16]  # judged by its first 64 KiB
            packs = len(zlib.compress(head, 1)) < len(head) // 2
            dst.writestr(info.filename, data,
                         compress_type=zipfile.ZIP_DEFLATED if packs else zipfile.ZIP_STORED)


def export_predict(detector, out_dir: str, bake_params: bool = True) -> str:
    """Export `detector.predict` for every config image bucket into `out_dir`.

    bake_params=True (default) saves the weights inside every program: the
    artifact is the model, at about the model's size per bucket.
    bake_params=False exports predict(params, image, image_hw) with the
    weights as call inputs: each program is a small fraction of the baked
    one, and the weights ship once as `params.npz` beside them. The programs
    run on `detector.device`'s type, which `meta.json` records under
    `platforms`. Returns `out_dir`.
    """
    os.makedirs(out_dir, exist_ok=True)
    buckets = [tuple(int(d) for d in b) for b in detector.cfg["tpu_image_buckets"]]
    device = detector.device
    module = PredictProgram(detector)
    if not bake_params:
        module = _ParamsAsInputs(module)
        params = dict(sorted(detector.state_dict().items()))
        save_params(os.path.join(out_dir, "params.npz"), detector)
    for h, w in buckets:
        detector.fill_caches((h, w))
        inputs = (torch.zeros((h, w, 3), device=device),
                  torch.tensor([h, w], dtype=torch.long, device=device))
        program = torch.export.export(module, inputs if bake_params else (params, *inputs),
                                      strict=False)
        _save(program, _bucket_path(out_dir, h, w))
    meta = {
        "format_version": _FORMAT_VERSION,
        "model_type": detector.model_type,
        "backbone": detector.backbone_name,
        "num_classes": detector.num_classes,
        "buckets": [list(b) for b in buckets],
        "platforms": [device.type],
        "params_baked": bake_params,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_predict(export_dir: str, device="cuda"):
    """Load an export directory -> (predict callable, meta dict).

    The callable takes (padded_image [H, W, 3], image_hw [2]) where (H, W)
    must be one of the exported buckets, runs the bucket's program on
    `device` and returns `Detections` there. Raises where CUDA is asked for
    and absent, where the artifact was exported for another platform than
    `device`'s and for an unknown format. On CUDA it turns TF32 off for the
    process, as a detector does (`ServingDetector._place`).
    """
    device = resolve_device(device)
    with open(os.path.join(export_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported export format {meta.get('format_version')}")
    if device.type not in meta["platforms"]:
        raise ValueError(f"the export in {export_dir} runs on {meta['platforms']}, "
                         f"not on {device.type}")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    programs = {(h, w): torch.export.load(_bucket_path(export_dir, h, w)).module()
                for h, w in (tuple(b) for b in meta["buckets"])}
    params = None
    if not meta.get("params_baked", True):
        flat = read_flat_params(os.path.join(export_dir, "params.npz"))
        params = {k: v.to(device) for k, v in sorted(state_dict_from_jax(flat).items())}

    def predict(image, image_hw) -> Detections:
        key = tuple(int(d) for d in image.shape[:2])
        if key not in programs:
            raise ValueError(f"image shape {key} is not an exported bucket {sorted(programs)}")
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        image_hw = torch.as_tensor(image_hw, device=device).long()
        inputs = (image, image_hw) if params is None else (params, image, image_hw)
        with torch.inference_mode():
            return Detections(*programs[key](*inputs))

    return predict, meta
