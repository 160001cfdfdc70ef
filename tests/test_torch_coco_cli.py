"""The port's COCO command lines on the CPU, at a tiny size.

- `coco_rehearsal run` (generate -> `train --data_type coco` -> `eval_coco`)
  with 2 train / 4 val images and 3 steps at a 128x128 bucket: the
  checkpoint, the results JSON and the 12 stats appear, and the
  `COCO80_REHEARSAL` line parses; the stats `eval_coco` printed from the
  checkpoint `train --data_type coco` wrote are those of its results JSON;
  `infer --data_type coco` prints labels of the 80 classes;
- `eval_coco` of the port and of the JAX package (the root script) on one
  `.npz` of seeded numpy weights over the same images: per image the same
  categories in the same order, scores within 1e-4 and boxes within 1e-3
  px (the two frameworks' convolutions sum in another order, as in
  tests/test_torch_model.py), and the stats of the two results within 1e-6;
  each expensive comparison is one test of its own, so no xdist worker
  waits for another's result;
- `_voc_to_coco_json` writes the JAX script's file byte for byte, and
  `voc_rehearsal coco` (a tiny VOC tree, the untrained Pascal detector's
  checkpoint) prints a `COCO_REHEARSAL` line that parses;
- `eval_coco --data_parallel` refuses an N that does not divide the batch
  size or asks for absent CUDA devices; `voc_rehearsal consistency` runs
  the single, `--data_parallel 8` and `--spatial_partition 4` evaluations
  (JAX's three variants) and holds the second and third to the first.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.evaluation import coco_eval as jax_coco_eval
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.config.config_factory import (
    apply_config_overrides,
    config_factory,
)
from tf_eager_object_detection_tpu_torch.evaluation import coco_eval
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.scripts import (
    coco_rehearsal,
    eval_coco,
    infer,
    voc_rehearsal,
)
from tf_eager_object_detection_tpu_torch.training.checkpoints import CheckpointManager
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from test_torch_cli import TINY, _jax_rehearsal
from torch_shared import numpy_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = "tf_eager_object_detection_tpu_torch.scripts"
# TINY with four anchor scales: 12 anchors a cell, as the COCO config has
COCO_TINY = [ov for ov in TINY if not ov.startswith("scales=")] + ["scales=[1, 2, 4, 8]"]
STAT_NAMES = ["AP @[.50:.95]", "AP @.50", "AP @.75", "AP small", "AP medium", "AP large",
              "AR maxDets=1", "AR maxDets=10", "AR maxDets=100", "AR small", "AR medium",
              "AR large"]


def _run(args):
    """`python -m args` from the repository root -> the completed process. Two
    threads a process: the command lines' tiny models gain nothing from more,
    and beside the other test workers more threads only contend."""
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", *args], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def _overrides(args, overrides):
    for ov in overrides:
        args += ["--config_override", ov]
    return args


def test_coco_rehearsal_run(tmp_path, capsys):
    """`coco_rehearsal run` at the tiny config on the CPU: 2 train and 4 val
    images, 3 steps, at a learning rate of 1e-5 (after the rehearsal's own
    schedule, which it overrides: 2.5e-4 throws these random weights off in
    3 steps, to degenerate proposals and no detection, and the results JSON
    would be empty). Then `infer --data_type coco` from its checkpoint."""
    args = [f"{_PKG}.coco_rehearsal", "run", "--root", str(tmp_path), "--n_train", "2",
            "--n_val", "4", "--steps", "3", "--eval_batch_size", "2", "--device", "cpu"]
    proc = _run(_overrides(args, COCO_TINY + ["learning_rate_multi_lrs=[1e-5, 1e-6]"]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "epoch finished: 3 steps" in proc.stdout
    summary = json.loads(proc.stdout.split("COCO80_REHEARSAL ", 1)[1].splitlines()[0])
    assert summary["proof"] == "coco80_rehearsal"
    assert list(summary["metrics"]) == STAT_NAMES
    assert all(-1.0 <= v <= 1.0 for v in summary["metrics"].values())
    with open(tmp_path / "results_faster_rcnn_resnet50.json") as f:
        results = json.load(f)
    with open(tmp_path / "instances_val.json") as f:
        val = json.load(f)
    assert {r["image_id"] for r in results} <= {img["id"] for img in val["images"]}
    assert all(r["category_id"] in coco_rehearsal.COCO_CAT_IDS and 0 <= r["score"] <= 1
               for r in results)
    per_image = [sum(r["image_id"] == img["id"] for r in results) for img in val["images"]]
    # 80 classes of 20 proposals: the cap of 100 is reached
    assert max(per_image) == 100 and min(per_image) > 0
    assert summary["categories_detected"] == len({r["category_id"] for r in results}) > 1

    # `eval_coco` read the checkpoint `train --data_type coco` wrote, and its
    # printed stats are those of the results JSON it wrote
    logs = tmp_path / "logs_faster_rcnn_resnet50"
    assert "ckpt_00000003.pt" in os.listdir(logs)
    assert f"eval_coco {logs}" in proc.stdout
    stats = coco_eval.evaluate_coco_detections(str(tmp_path / "instances_val.json"),
                                               str(tmp_path / "results_faster_rcnn_resnet50.json"))
    assert coco_rehearsal.parse_stats(capsys.readouterr().out) == summary["metrics"]
    assert stats.shape == (12,)

    # `infer --data_type coco` prints labels of the 80 classes
    infer.main(_overrides([str(logs), str(tmp_path / "images" / "000002.jpg"), "--data_type",
                           "coco", "--out", str(tmp_path / "dets.png"), "--score_threshold", "0",
                           "--device", "cpu"], COCO_TINY))
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"wrote {tmp_path / 'dets.png'}" and len(lines) > 1
    for line in lines[:-1]:
        label, score, *box = line.replace("[", "").replace("]", "").replace(",", "").split()
        assert 1 <= int(label) <= 80 and 0.0 <= float(score) <= 1.0
        x1, y1, x2, y2 = map(float, box)
        assert 0 <= x1 <= x2 <= 800 and 0 <= y1 <= y2 <= 600


# ------------------------------------------- eval_coco, the port against JAX
ROI_SCORE_SCALE = 10.0  # spreads the 81 random-weight class scores (the cap picks 100 of them)


def _jax_eval_coco():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_coco", os.path.join(_ROOT, "scripts", "eval_coco.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _eval_both(root):
    """Both `eval_coco`s on one `.npz` over 4 procedural val images, tf
    preprocessing (pixels in [-1, 1], the scale of the numpy weights)."""
    coco_rehearsal.generate(str(root), 0, 4, seed=5)
    cfg = apply_config_overrides(dict(config_factory("coco", "faster_rcnn")), COCO_TINY)
    flat = numpy_params(jax_factory("faster_rcnn", "resnet50", cfg), seed=3)
    flat["rpn_head/rpn_score_conv/kernel"] *= 5.0
    flat["roi_head/roi_head_score/kernel"] *= ROI_SCORE_SCALE
    np.savez(root / "params.npz", **flat)
    common = [str(root / "params.npz"), "--annotation_file", str(root / "instances_val.json"),
              "--image_dir", str(root / "images"), "--batch_size", "2",
              "--preprocessing_type", "tf"]
    port_json, jax_json = str(root / "port.json"), str(root / "jax.json")
    out = {}
    for name, fn, argv in (
            ("port", eval_coco.main, common + ["--results_json", port_json, "--device", "cpu"]),
            ("jax", lambda a: _jax_eval_coco().main(), common + ["--results_json", jax_json])):
        argv = _overrides(argv, COCO_TINY)
        buf = io.StringIO()
        with mock.patch.object(sys, "argv", ["eval_coco"] + argv), contextlib.redirect_stdout(buf):
            fn(argv)
        out[name] = buf.getvalue()
    with open(root / "instances_val.json") as f:
        gt = json.load(f)
    results = {}
    for name, path in (("port", port_json), ("jax", jax_json)):
        with open(path) as f:
            results[name] = json.load(f)
    return dict(out=out, results=results,
                stats={"port": coco_eval.CocoBboxEval(gt, results["port"]).evaluate(),
                       "jax": jax_coco_eval.CocoBboxEval(gt, results["jax"]).evaluate()})


def test_eval_coco_matches_jax(tmp_path):
    both = _eval_both(tmp_path)
    got, want = both["results"]["port"], both["results"]["jax"]
    assert len(got) == len(want) > 100  # the per-image cap of 100 is reached
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
    assert min(r["score"] for r in got) > 1e-30  # no denormal score in either framework
    assert max(sum(r["image_id"] == i for r in got) for i in {r["image_id"] for r in got}) == 100
    np.testing.assert_allclose(both["stats"]["port"], both["stats"]["jax"], rtol=0, atol=1e-6)
    # each command line printed its summary, 12 stats parsed back
    for name in ("port", "jax"):
        parsed = coco_rehearsal.parse_stats(both["out"][name])
        assert list(parsed) == STAT_NAMES
        np.testing.assert_allclose(list(parsed.values()), both["stats"][name], atol=5e-4)


def test_eval_coco_refuses_data_parallel():
    """`--data_parallel` is ported (tests/test_torch_parallel_trainer.py
    evaluates with it); it refuses, before the checkpoint is read, an N
    that does not divide the batch size and CUDA devices that are not there."""
    common = ["x.npz", "--annotation_file", "a.json", "--image_dir", "."]
    with pytest.raises(ValueError, match="batch_size=8 not divisible by data_parallel=3"):
        eval_coco.main(common + ["--data_parallel", "3", "--device", "cpu"])
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} CUDA devices"):
        eval_coco.main(common + ["--data_parallel", str(have + 1), "--batch_size",
                                 str(have + 1), "--device", "cuda"])


# --------------------------------------------------- voc_rehearsal coco
def test_voc_to_coco_json_byte_identical(tmp_path):
    voc_root = str(tmp_path / "VOC2007")
    voc_rehearsal.generate(voc_root, 2, 20, seed=0)
    n = voc_rehearsal._voc_to_coco_json(voc_root, "test", str(tmp_path / "p.json"))
    want = _jax_rehearsal()._voc_to_coco_json(voc_root, "test", str(tmp_path / "j.json"))
    assert n == want > 0
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_voc_rehearsal_coco_prints_12_stats(tmp_path):
    """`voc_rehearsal coco` over a tiny tree's test split (20 images) from a
    checkpoint of the seeded, untrained Pascal detector at the tiny config."""
    root = tmp_path
    voc_rehearsal.generate(str(root / "VOC2007"), 2, 20, seed=0)
    cfg = apply_config_overrides(dict(config_factory("pascal", "faster_rcnn")), TINY)
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=0)
    CheckpointManager(str(root / "logs_faster_rcnn_resnet50")).save(det, make_optimizer(cfg, det))
    args = [f"{_PKG}.voc_rehearsal", "coco", "--root", str(root), "--eval_batch_size", "2",
            "--device", "cpu"]
    proc = _run(_overrides(args, TINY))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.split("COCO_REHEARSAL ", 1)[1].splitlines()[0])
    assert summary["proof"] == "coco_rehearsal" and summary["n_gt_annotations"] > 20
    assert list(summary["metrics"]) == STAT_NAMES
    assert all(-1.0 <= v <= 1.0 for v in summary["metrics"].values())
    with open(root / "coco_results_faster_rcnn_resnet50.json") as f:
        assert all(1 <= r["category_id"] <= 20 for r in json.load(f))


def test_voc_rehearsal_consistency_is_not_ported(tmp_path):
    """`voc_rehearsal consistency` with all three of JAX's variants (the
    name is from before the `sp4` variant was ported): over the first 8
    test images of a tiny tree, from a checkpoint of the seeded, untrained
    Pascal detector at the tiny config, `eval_pascal` on the CPU on one
    device (an image at a time), as `--data_parallel 8` (a replica an
    image) and as `--spatial_partition 4` (four gloo ranks, each image's
    rows sharded over them). dp8 writes byte-identical detection files and
    an equal mAP; sp4's files equal single's byte for byte or, where the
    CPU's convolutions of a shard's rows sum in another order than the
    whole map's and move a printed digit, line for line within the
    script's bounds (scores 1.5e-3, coordinates 0.15 px, mAP 1e-3; each
    differing line printed as `DIFFERS`)."""
    root = tmp_path
    voc_rehearsal.generate(str(root / "VOC2007"), 2, 20, seed=0)
    cfg = apply_config_overrides(dict(config_factory("pascal", "faster_rcnn")), TINY)
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=0)
    CheckpointManager(str(root / "logs_faster_rcnn_resnet50")).save(det, make_optimizer(cfg, det))
    args = [f"{_PKG}.voc_rehearsal", "consistency", "--root", str(root), "--n_consistency", "8",
            "--device", "cpu"]
    proc = _run(_overrides(args, TINY))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.split("CONSISTENCY ", 1)[1].splitlines()[0])
    assert summary["n_images"] == 8 and sorted(summary["mAP"]) == ["dp8", "single", "sp4"]
    assert summary["bounds"] == {"score": 1.5e-3, "box_px": 0.15, "mAP": 1e-3}
    dp8, sp4 = summary["variants"]["dp8"], summary["variants"]["sp4"]
    assert dp8["files_identical"] and dp8["map_gap"] == 0.0
    assert sp4["consistent"] and sp4["max_score_move"] <= 1.5e-3 and sp4["max_box_move"] <= 0.15
    differing = [line for line in proc.stdout.splitlines() if line.startswith("DIFFERS sp4 ")]
    assert len(differing) == sp4["differing_lines"] and sp4["files_identical"] == (not differing)
    for name in ("single", "sp4"):
        sizes = [os.path.getsize(p) for p in (root / f"consistency_faster_rcnn_{name}").glob(
            "*.txt")]
        assert len(sizes) == 20 and sum(sizes) > 0
