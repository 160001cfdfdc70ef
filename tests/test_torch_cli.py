"""The port's command lines and rehearsal generator, on the CPU.

- `apply_config_overrides` equals the JAX function on a set of overrides,
  errors included.
- The port's `voc_rehearsal.generate` writes the tree of the JAX script's
  `generate` for the same seed: annotations and image sets byte-identical,
  JPEG pixels equal after decoding (and `draw_image` equal before any
  encoding).
- Every command line runs as `python -m ... --help`; `train` refuses COCO
  FPN, as JAX does, and `--spatial_partition` > 1 without a process group
  (naming torchrun) or with `--multihost`.
- A tiny rehearsal on the CPU through `voc_rehearsal run` (generate ->
  TFRecords -> `train` -> `eval_pascal`) prints 20 `AP =` lines; the eval
  command line gives the same APs from the local result files and from
  eval TFRecords; `infer` prints and draws its detections.
"""

import importlib.util
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from tf_eager_object_detection_tpu.config.config_factory import (
    apply_config_overrides as jax_apply_config_overrides,
)
from tf_eager_object_detection_tpu_torch.config.config_factory import (
    apply_config_overrides,
    config_factory,
)
from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
from tf_eager_object_detection_tpu_torch.scripts import train as train_cli
from tf_eager_object_detection_tpu_torch.scripts import voc_rehearsal

from torch_shared import shared

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = "tf_eager_object_detection_tpu_torch.scripts"

# a 128x128 bucket and anchor scales (2, 4, 8), as tests/test_torch_faster_rcnn_train.py
TINY = ["scales=[2, 4, 8]", "rpn_proposal_train_pre_nms_sample_number=256",
        "rpn_proposal_train_after_nms_sample_number=64", "rpn_total_sample_number=64",
        "rpn_pos_sample_max_number=32", "roi_total_sample_number=32",
        "roi_pos_sample_max_number=8", "rpn_proposal_test_pre_nms_sample_number=100",
        "rpn_proposal_test_after_nms_sample_number=20", "tpu_image_buckets=[[128, 128]]",
        "image_min_size=128", "image_max_size=128"]


def _jax_rehearsal():
    spec = importlib.util.spec_from_file_location(
        "jax_voc_rehearsal", os.path.join(_ROOT, "scripts", "voc_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=_ROOT)
    return subprocess.run([sys.executable, "-m", *args], cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=600, **kw)


# ------------------------------------------------------- config overrides
@pytest.mark.parametrize("overrides", [
    ["image_min_size=96"],
    ["tpu_image_buckets=[[256, 256], [256, 320]]", "scales=[2, 4, 8]"],
    ["bgr_pixel_means=[1.5, 2, 3]", "strict_reference_parity=true"],
    ["tpu_compute_dtype=bfloat16"],
    ['tpu_compute_dtype="float32"'],
    ["prediction_score_threshold=-0.5"],
    ["no_such_key=1"],
    ["image_min_size"],
    ["tpu_image_buckets=[[256, 256]"],
    ["image_min_size="],
    ["scales='bad'"],
])
def test_apply_config_overrides_matches_jax(overrides):
    def outcome(fn):
        cfg = dict(config_factory("pascal", "faster_rcnn"))
        try:
            return "ok", fn(cfg, overrides)
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            return type(exc).__name__, str(exc)

    got, want = outcome(apply_config_overrides), outcome(jax_apply_config_overrides)
    assert got == want


# ---------------------------------------------------- rehearsal generator
@pytest.mark.parametrize("seed", [1, 7])
def test_draw_image_matches_jax(seed):
    jax_img, jax_objs = _jax_rehearsal().draw_image(np.random.RandomState(seed))
    img, objs = voc_rehearsal.draw_image(np.random.RandomState(seed))
    assert objs == jax_objs and len(objs) > 0
    np.testing.assert_array_equal(img, jax_img)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    counts = voc_rehearsal.generate(str(root / "port"), 2, 20, seed=0)
    jax_counts = _jax_rehearsal().generate(str(root / "jax"), 2, 20, seed=0)
    assert counts == jax_counts
    return root / "port", root / "jax"


def _files(root, sub):
    return sorted(os.listdir(root / sub))


@pytest.mark.parametrize("sub", ["Annotations", "ImageSets/Main"])
def test_generate_writes_the_jax_text_files(trees, sub):
    port, jax = trees
    assert _files(port, sub) == _files(jax, sub) and _files(port, sub)
    for name in _files(port, sub):
        assert (port / sub / name).read_bytes() == (jax / sub / name).read_bytes(), name


def test_generate_writes_the_jax_images(trees):
    port, jax = trees
    assert _files(port, "JPEGImages") == _files(jax, "JPEGImages")
    for name in _files(port, "JPEGImages"):
        a, b = (cv2.imread(str(r / "JPEGImages" / name)) for r in (port, jax))
        assert a.shape == (600, 800, 3)
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------- command lines
@pytest.mark.parametrize("module", ["train", "eval_pascal", "infer", "generate_pascal_tf_records",
                                    "voc_rehearsal"])
def test_cli_help(module):
    proc = _run([f"{_PKG}.{module}", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage:")


@pytest.mark.parametrize("flags,item", [(["--data_type", "coco"], "--model_type fpn")])
def test_train_refuses_what_is_not_ported(flags, item):
    """`--data_type coco` is ported (tests/test_torch_coco_cli.py); COCO FPN
    has no config in either package, and the port refuses it as JAX does."""
    with pytest.raises(ValueError, match="dataset type coco and model type fpn"):
        train_cli.main(["--device", "cpu", *flags, *item.split()])


@pytest.mark.parametrize("flag", ["--data_parallel", "--multihost", "--backbone_weights=x"])
def test_train_has_no_option_of_later_items(flag, monkeypatch):
    """Items 8(a)-(c) are ported: the data-parallel flags (tests/
    test_torch_parallel_trainer.py trains with them), `--backbone_weights`
    (item 9(a), loaded in tests/test_torch_ref_import.py) and
    `--spatial_partition` (item 8(c), tests/test_torch_spatial.py) parse and
    are passed on. `--spatial_partition 2` with each flag refuses before
    anything is joined or built: without torchrun's environment (naming
    torchrun), and with `--multihost`, which JAX refuses too."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    args = train_cli.parse_args([flag, "--spatial_partition", "2"])
    assert args.spatial_partition == 2
    if flag.startswith("--backbone_weights"):
        assert args.backbone_weights == "x"
    else:
        assert getattr(args, flag[2:]) is True
    argv = [flag, "--spatial_partition", "2", "--device", "cpu"]
    if flag == "--multihost":
        with pytest.raises(SystemExit, match="--spatial_partition with --multihost"):
            train_cli.main(argv)
    else:
        with pytest.raises(RuntimeError, match="torchrun"):
            train_cli.main(argv)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """`voc_rehearsal run` at the tiny config on the CPU: 4 train and 20
    test images, 3 steps."""
    def run():
        root = tmp_path_factory.mktemp("rehearsal")
        args = [f"{_PKG}.voc_rehearsal", "run", "--root", str(root), "--n_train", "4",
                "--n_test", "20", "--steps", "3", "--eval_batch_size", "2", "--device", "cpu"]
        for ov in TINY:
            args += ["--config_override", ov]
        return root, _run(args)

    return shared(tmp_path_factory, "torch_cli_rehearsal", run)


def _aps(stdout):
    return {p[0]: float(p[3]) for p in (line.split() for line in stdout.splitlines())
            if len(p) == 4 and p[1:3] == ["AP", "="]}


def _eval(root, *extra):
    args = [f"{_PKG}.eval_pascal", "--root_path", str(root / "VOC2007"), "--model_type",
            "faster_rcnn", "--device", "cpu", "--batch_size", "2", *extra]
    for ov in TINY:
        args += ["--config_override", ov]
    return _run(args)


def test_rehearsal_run_trains_and_prints_20_aps(rehearsal):
    root, proc = rehearsal
    assert proc.returncode in (0, 1), proc.stderr[-3000:]  # 1: mAP below 0.85
    assert "epoch finished: 3 steps" in proc.stdout
    aps = _aps(proc.stdout)
    assert sorted(aps) == sorted(PASCAL_CLASSES)
    assert all(0.0 <= v <= 1.0 for v in aps.values())
    summary = json.loads(proc.stdout.split("VOC_REHEARSAL ", 1)[1].splitlines()[0])
    assert summary["classes_populated"] == 20
    assert proc.returncode == (0 if summary["mAP"] >= 0.85 else 1)
    assert "ckpt_00000003.pt" in os.listdir(root / "logs_faster_rcnn_resnet50")


def test_eval_of_local_result_files_gives_the_same_aps(rehearsal):
    root, proc = rehearsal
    out = _eval(root, "--use_local_result_files", "--result_dir",
                str(root / "results_faster_rcnn_resnet50"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert _aps(out.stdout) == _aps(proc.stdout)


def test_eval_from_tf_records_equals_eval_from_jpegs(rehearsal, tmp_path):
    root, proc = rehearsal
    gen = _run([f"{_PKG}.generate_pascal_tf_records", "--voc_root", str(root / "VOCdevkit"),
                "--mode", "test", "--output_dir", str(tmp_path), "--num_shards", "1"])
    assert gen.returncode == 0, gen.stderr
    out = _eval(root, str(root / "logs_faster_rcnn_resnet50"), "--dataset_type", "tf",
                "--tf_records_glob", str(tmp_path / "*test*.tfrecords"), "--result_dir",
                str(tmp_path / "results"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert _aps(out.stdout) == _aps(proc.stdout)


def test_infer_prints_and_draws_detections(rehearsal, tmp_path):
    root, _ = rehearsal
    image = root / "VOC2007" / "JPEGImages" / "000004.jpg"
    args = [f"{_PKG}.infer", str(root / "logs_faster_rcnn_resnet50"), str(image), "--out",
            str(tmp_path / "dets.png"), "--score_threshold", "0", "--device", "cpu"]
    for ov in TINY:
        args += ["--config_override", ov]
    out = _run(args)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == f"wrote {tmp_path / 'dets.png'}"
    for line in lines[:-1]:
        name, score, *box = line.replace("[", "").replace("]", "").replace(",", "").split()
        assert name in PASCAL_CLASSES and 0.0 <= float(score) <= 1.0
        x1, y1, x2, y2 = map(float, box)
        assert 0 <= x1 <= x2 <= 800 and 0 <= y1 <= y2 <= 600
    assert cv2.imread(str(tmp_path / "dets.png")).shape == (600, 800, 3)
