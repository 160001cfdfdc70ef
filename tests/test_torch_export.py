"""The port's operator library (`ops/kernels/library.py`) and serving export
(`serving/export.py`, `scripts/export.py`) on the CPU.

- `torch.library.opcheck` of the three `tf_eager_od` operators at small
  shapes (schema, autograd registration, fake kernel, AOT dispatch), the
  RoIAlign ones on float32 and bfloat16 planes, four of them and one; and
  each operator on CPU tensors equal to its plain version, with no launch.
- A small Faster R-CNN ResNet-50: the buckets [[64, 64], [96, 64]] and the
  proposal counts of tests/test_serving.py::_small_cfg, JAX's init weights
  (`torch_shared.jax_init`, the RPN score layer x20) with the RoI score
  layer x10, so that scores separate. Its export, weights baked, is made
  once per session (`torch_shared.shared`): reloaded, each bucket equals
  the port's direct `predict` within 1e-5 (labels and validity equal) and
  agrees with JAX's `predict` on the same weights within the tolerances of
  tests/test_torch_model.py (boxes 1e-3 px, scores 1e-4; labels and
  validity equal); the detector's own `predict` is bit-equal before and
  after its export. `scripts/export.py --device cpu --check
  --no_bake_params` from the detector's saved `.npz` (one bucket) serves
  what the baked artifact serves, from a program under 1% of the baked
  one's size. Non-buckets, other platforms and unknown formats are refused.
- On the card (marked `gpu`, skips here): the same detector exported on
  CUDA and reloaded equals its direct `predict`, and K1 launches from the
  reloaded program.

JAX is imported only by the test that runs it, so the `gpu` case runs on a
machine without JAX.
"""

import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as port_nms
from tf_eager_object_detection_tpu_torch.ops import roi_align as port_roi
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import ROI_ALIGN_KERNEL
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import load_jax_params
from tf_eager_object_detection_tpu_torch.scripts import export as export_cli
from tf_eager_object_detection_tpu_torch.serving.export import export_predict, load_predict
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params

from torch_shared import jax_init, shared

RPN_SCORE_SCALE = 20.0
ROI_SCORE_SCALE = 10.0
BUCKETS = [(64, 64), (96, 64)]
TOL = dict(rtol=1e-5, atol=1e-5)
BOX_TOL = dict(rtol=0, atol=1e-3)  # against JAX: tests/test_torch_model.py's reasons
SCORE_TOL = dict(rtol=0, atol=1e-4)
OPS = torch.ops.tf_eager_od


# tests/test_serving.py::_small_cfg's changes to the stock config
SMALL = dict(
    rpn_proposal_train_pre_nms_sample_number=256,
    rpn_proposal_train_after_nms_sample_number=64,
    rpn_proposal_test_pre_nms_sample_number=256,
    rpn_proposal_test_after_nms_sample_number=32,
    roi_total_sample_number=32,
    roi_pos_sample_max_number=8,
    rpn_total_sample_number=64,
    rpn_pos_sample_max_number=32,
)


def _small_cfg():
    """tests/test_serving.py::_small_cfg, from the port's config."""
    return dict(config_factory("pascal", "faster_rcnn"), **SMALL,
                tpu_image_buckets=[list(b) for b in BUCKETS])


def _requests():
    """One padded image per bucket with its valid extent."""
    rng = np.random.RandomState(0)
    return [(rng.randn(h, w, 3).astype(np.float32), np.asarray([h - 4, w - 2], np.int32))
            for h, w in BUCKETS]


def _numpy(det):
    return [t.cpu().numpy() for t in det]


def _assert_same(got, want, box_tol=TOL, score_tol=TOL):
    boxes, labels, scores, valid = got
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(labels, want[1])
    np.testing.assert_allclose(boxes, want[0], **box_tol)
    np.testing.assert_allclose(scores, want[2], **score_tol)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    flat = dict(jax_init(tmp_path_factory, "faster_rcnn", RPN_SCORE_SCALE))
    key = "roi_head/roi_head_score/kernel"
    flat[key] = flat[key] * ROI_SCORE_SCALE
    return flat


def _detector(flat, device="cpu", buckets=BUCKETS):
    cfg = dict(_small_cfg(), tpu_image_buckets=[list(b) for b in buckets])
    det = model_factory("faster_rcnn", "resnet50", cfg, device=device)
    load_jax_params(det, flat)
    return det


@pytest.fixture(scope="module")
def baked(tmp_path_factory, flat):
    """The baked export, made once per session: its directory and the
    exporting detector's direct `predict` of each request before and after."""

    def compute():
        det = _detector(flat)
        before = [_numpy(det.predict(*r)) for r in _requests()]
        out = str(tmp_path_factory.mktemp("export_baked"))
        export_predict(det, out)
        return {"dir": out, "before": before,
                "after": [_numpy(det.predict(*r)) for r in _requests()]}

    return shared(tmp_path_factory, "torch_export_baked", compute)


@pytest.fixture(scope="module")
def loaded(baked):
    """`load_predict` of the baked export on the CPU, once per worker."""
    return load_predict(baked["dir"], device="cpu")


# ------------------------------------------------------------- the operators
def _roi_args(dtype, levels):
    rng = np.random.RandomState(3)
    strides = (4, 8, 16, 32)[:levels]
    planes = [torch.from_numpy(rng.randn(2, 48 // s, 64 // s, 8).astype(np.float32)).to(dtype)
              for s in strides]
    xy = rng.uniform(0, 40, (2, 5, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(4, 20, (2, 5, 2))], -1)
                            .astype(np.float32))
    lv = torch.from_numpy(rng.randint(0, levels, (2, 5)))
    valid = torch.from_numpy(rng.uniform(size=(2, 5)) > 0.2)
    return (planes, rois, lv, valid, torch.tensor([44.0, 48.0]), torch.tensor([60.0, 64.0]), 4,
            list(strides))


def _nms_args():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (2, 300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (2, 300, 2))], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.uniform(size=(2, 300)) > 0.1), 0.5, 50


@pytest.mark.parametrize("case", ["nms", "roi_align-float32-4", "roi_align-bfloat16-4",
                                  "roi_align-float32-1", "roi_align_backward-float32-4",
                                  "roi_align_backward-bfloat16-1"])
def test_opcheck(case):
    if case == "nms":
        op, args = OPS.nms_alive_sorted.default, _nms_args()
    else:
        name, dtype, levels = case.split("-")
        args = _roi_args(getattr(torch, dtype), int(levels))
        if name == "roi_align":
            op = OPS.roi_align.default
            args = ([p.requires_grad_() for p in args[0]], *args[1:])
        else:
            op = OPS.roi_align_backward.default
            b, n = args[1].shape[:2]
            args = (torch.randn(b, n, 4, 4, 8), *args)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_take_the_plain_versions_on_cpu(dtype):
    """Forward, gradient (through `register_autograd`) and NMS equal the plain
    versions bit for bit; no kernel launches."""
    launches = (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches)
    planes, *rest = _roi_args(dtype, 4)
    leaves = [p.clone().requires_grad_() for p in planes]
    out = port_roi.roi_align_multilevel(leaves, *rest)
    assert torch.equal(out, port_roi.roi_align_multilevel_reference(planes, *rest))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, leaves, g)
    want = port_roi.roi_align_multilevel_reference_backward(g, planes, *rest)
    assert [d.dtype for d in got] == [dtype] * 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    boxes, valid, thr, cap = _nms_args()
    assert torch.equal(port_nms.nms_alive_sorted(boxes, valid, thr, cap),
                       port_nms.nms_alive_sorted_reference(boxes, valid, thr, cap))
    assert (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches) == launches


def test_op_refuses_another_backend():
    """A backend with no kernel (here sparse CPU tensors) raises."""
    boxes, valid, thr, cap = _nms_args()
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        OPS.nms_alive_sorted(boxes.to_sparse(), valid.to_sparse(), thr, cap)


# ---------------------------------------------------------------- the export
def test_round_trip_equals_direct_predict(baked, loaded):
    predict, meta = loaded
    assert meta == {"format_version": 1, "model_type": "faster_rcnn", "backbone": "resnet50",
                    "num_classes": 21, "buckets": [list(b) for b in BUCKETS],
                    "platforms": ["cpu"], "params_baked": True}
    for request, want in zip(_requests(), baked["before"]):
        got = predict(*request)
        assert got.boxes.device.type == "cpu"
        _assert_same(_numpy(got), want)
    assert sum(int(w[3].sum()) for w in baked["before"]) > 0


def test_program_calls_the_operators(baked):
    """The saved graph names K1's operator at its two calls (the RPN and the
    classes), and RoIAlign's nowhere (C4 crops with two matmuls)."""
    with zipfile.ZipFile(os.path.join(baked["dir"], "predict_64x64.pt2")) as z:
        text = "".join(z.read(i).decode("latin-1") for i in z.infolist())
    assert text.count("tf_eager_od.nms_alive_sorted.default") == 2
    assert "tf_eager_od.roi_align" not in text


def test_detector_predict_unchanged_after_export(baked):
    for before, after in zip(baked["before"], baked["after"]):
        for a, b in zip(before, after):
            np.testing.assert_array_equal(a, b)


def test_round_trip_agrees_with_jax_predict(loaded, flat):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory

    jdet = jax_factory("faster_rcnn", "resnet50", _small_cfg())
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    predict, _ = loaded
    image, hw = _requests()[0]
    want = [np.asarray(t) for t in jdet.predict(params, jnp.asarray(image), jnp.asarray(hw))]
    _assert_same(_numpy(predict(image, hw)), want, BOX_TOL, SCORE_TOL)
    assert want[3].sum() > 0


def test_refuses_a_shape_that_is_not_a_bucket(loaded):
    predict, _ = loaded
    with pytest.raises(ValueError, match="not an exported bucket"):
        predict(np.zeros((60, 60, 3), np.float32), np.asarray([60, 60], np.int32))


def _meta_only(tmp_path, **change):
    """An export directory with only a `meta.json` (the refusals come before
    any program is read)."""
    meta = {"format_version": 1, "model_type": "faster_rcnn", "backbone": "resnet50",
            "num_classes": 21, "buckets": [list(b) for b in BUCKETS], "platforms": ["cpu"],
            "params_baked": True}
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({**meta, **change}, f)
    return str(tmp_path)


@pytest.mark.parametrize("case", ["cpu-for-cuda", "cuda-for-cpu", "cuda-without-cuda", "format"])
def test_refuses_other_platforms_and_formats(tmp_path, case):
    if case == "format":
        with pytest.raises(ValueError, match="unsupported export format 2"):
            load_predict(_meta_only(tmp_path, format_version=2), device="cpu")
    elif case == "cpu-for-cuda":
        with pytest.raises(ValueError, match="runs on \\['cuda'\\], not on cpu"):
            load_predict(_meta_only(tmp_path, platforms=["cuda"]), device="cpu")
    elif torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    elif case == "cuda-for-cpu":
        with pytest.raises(RuntimeError, match="cuda"):
            load_predict(_meta_only(tmp_path), device="cuda")
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            load_predict(_meta_only(tmp_path, platforms=["cuda"]))


def test_script_exports_program_only_from_a_saved_npz(baked, loaded, flat, tmp_path, capsys):
    """`scripts/export.py --no_bake_params --check --device cpu` on the
    detector's `.npz` (one bucket): the program-only artifact serves what
    the baked one serves, from under 1% of its size."""
    npz = str(tmp_path / "params.npz")
    save_params(npz, _detector(flat))
    out = str(tmp_path / "export")
    export_cli.main([npz, "--out_dir", out, "--device", "cpu", "--no_bake_params", "--check",
                     *(f"--config_override={k}={json.dumps(v)}" for k, v in SMALL.items()),
                     "--config_override=tpu_image_buckets=[[64, 64]]"])
    printed = capsys.readouterr().out
    assert f"exported to {out}" in printed
    assert "smoke inference ok:" in printed and "(bucket 64x64)" in printed
    assert sorted(os.listdir(out)) == ["meta.json", "params.npz", "predict_64x64.pt2"]
    predict, meta = load_predict(out, device="cpu")
    assert meta["params_baked"] is False and meta["buckets"] == [[64, 64]]
    request = _requests()[0]
    _assert_same(_numpy(predict(*request)), _numpy(loaded[0](*request)))
    _assert_same(_numpy(predict(*request)), baked["before"][0])
    slim = os.path.getsize(os.path.join(out, "predict_64x64.pt2"))
    full = os.path.getsize(os.path.join(baked["dir"], "predict_64x64.pt2"))
    assert slim < 0.01 * full, (slim, full)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.gpu
def test_export_reloads_on_the_card(tmp_path):
    """Exported on CUDA and reloaded: equal to the detector's direct
    `predict` within 1e-4 px and 1e-5, K1 launched by the program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    det = model_factory("faster_rcnn", "resnet50", _small_cfg(), device="cuda", seed=3)
    want = [_numpy(det.predict(*r)) for r in _requests()]
    export_predict(det, str(tmp_path))
    predict, meta = load_predict(str(tmp_path))
    assert meta["platforms"] == ["cuda"]
    for request, w in zip(_requests(), want):
        NMS_KERNEL.reset_launches()
        got = predict(*request)
        torch.cuda.synchronize()
        assert NMS_KERNEL.launches == 2 and got.boxes.device.type == "cuda"
        _assert_same(_numpy(got), w, dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-5))
