"""The port's trainer, command lines and eval under data parallelism, on the CPU.

Every multi-process case runs its processes with a deadline, kills those
left at it and fails with their output (`tests/torch_ddp_worker.py::
run_processes`); the library cases join over a `file://` store, the
command line over `tcp://127.0.0.1:<free port>` (a port taken by another
process between choosing and binding is retried once with another).

- `Trainer(data_parallel=True)` over two gloo ranks takes 2 steps of a
  global batch of 2 from the TFRecords of a tiny procedural VOC tree (the
  tiny config of tests/test_torch_cli.py): its metric log (summaries at
  every step) equals a single-process `Trainer` at B = 2 on the same
  records within rtol 1e-5; only rank 0 prints `step n ...` and writes
  the events and the one checkpoint; a fresh two-rank `Trainer` on the
  directory restores parameters, momentum traces and the step count
  bit-equal on both ranks;
- a global batch of 3 on two ranks raises ValueError ("not divisible") on
  both ranks, before the step's first collective: no hang;
- `train --multihost --coordinator_address 127.0.0.1:<port>
  --num_processes 2 --process_id r --device cpu --batch_size 1` for 2
  steps (the counterpart of JAX tests/test_multihost_cli.py, which JAX
  marks slow): rank 0's metric log equals `train --batch_size 2` in one
  process within rtol 1e-5, and rank 1 prints no `step` line;
- `eval_coco --data_parallel 2 --device cpu` (batches of 2, shards of 1)
  gives the 12 stats of `--data_parallel 0`, and its results JSON within
  1e-6 (the CPU's convolutions at B = 1 and B = 2 differ in the last
  bits);
- `get_prediction_files(..., data_parallel=2)` writes VOC detection files
  byte-identical to `data_parallel=0` (8 test images, batch 4);
- every `--spatial_partition` > 1 (train, eval_pascal, infer, `Trainer`)
  refuses without a process group, saying how to launch (torchrun), and
  with a world size that it does not divide, before joining or building
  anything (tests/test_torch_spatial.py runs them under one).
"""

import contextlib
import io
import json
import os
import shutil
import socket
import sys

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import (
    apply_config_overrides,
    config_factory,
)
from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
from tf_eager_object_detection_tpu_torch.data.pascal import pascal_eval_iterator
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.evaluation.pascal_eval_files import get_prediction_files
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.scripts import coco_rehearsal, eval_coco, eval_pascal
from tf_eager_object_detection_tpu_torch.scripts import infer as infer_cli
from tf_eager_object_detection_tpu_torch.scripts import train as train_cli
from tf_eager_object_detection_tpu_torch.scripts import voc_rehearsal
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer
from test_torch_cli import TINY
from torch_ddp_worker import run_processes, run_ranks, save_inputs
from torch_shared import shared

PKG = "tf_eager_object_detection_tpu_torch.scripts"
STEPS = 2
TIMEOUT_S = 300.0


def _tiny_cfg(data_type="pascal"):
    overrides = TINY if data_type == "pascal" else (
        [ov for ov in TINY if not ov.startswith("scales=")] + ["scales=[1, 2, 4, 8]"])
    return apply_config_overrides(dict(config_factory(data_type, "faster_rcnn")), overrides)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A procedural VOC tree (4 trainval, 20 test images: every class in
    the test split) and its trainval TFRecords, once per session."""
    def make():
        root = tmp_path_factory.mktemp("parallel_tree")
        voc = root / "VOCdevkit" / "VOC2007"
        voc_rehearsal.generate(str(voc), 4, 20, seed=0)
        records = create_pascal_tf_records(str(root / "VOCdevkit"), "2007", "trainval",
                                           str(root / "tfrecords"), num_shards=2)
        return str(root), records

    return shared(tmp_path_factory, "torch_parallel_tree", make)


def _metric_log(train_dir):
    with open(os.path.join(train_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_logs_equal(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k not in ("time", "step"):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=0, err_msg=k)


def _single_trainer(records, train_dir):
    """One process at B = 2 over the records, on one thread as the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _tiny_cfg()
        det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=0)
        trainer = Trainer(det, train_dir, logging_every_n_steps=1, summary_every_n_steps=1,
                          saving_every_n_steps=STEPS, seed=0)
        data_cfg = {"model_config": cfg, "batch_size": 2, "preprocessing_type": "caffe",
                    "seed": 0, "tf_records_list": records}
        trainer.train(dataset_factory("pascal", "train", data_cfg), 1, STEPS)
    finally:
        torch.set_num_threads(threads)
    return _metric_log(train_dir)


def _trainer_run(tree, tmp):
    root, records = tree
    tmp = str(tmp)
    spec = dict(mode="trainer", model_type="faster_rcnn", backbone="resnet50", cfg=_tiny_cfg(),
                seed=0, records=records, global_batch=2, steps=STEPS,
                train_dir=os.path.join(tmp, "dp"))
    results = run_ranks(spec, tmp, timeout_s=TIMEOUT_S)
    ranks = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(2)]
    digests = [{k: str(r[k]) for k in r.files if k.startswith("digest/")} for r in ranks]
    out = {
        "outputs": [out for _, out in results],
        "dp_log": _metric_log(spec["train_dir"]),
        "single_log": _single_trainer(records, os.path.join(tmp, "single")),
        "files": sorted(os.listdir(spec["train_dir"])),
        "counts": [(int(r["count"]), int(r["restored_count"])) for r in ranks],
        "restored_equal": [bool(r["restored_equal"]) for r in ranks],
        "ranks_equal": bool(digests[0]) and digests[0] == digests[1],
        "n_traces": int(ranks[0]["n_traces"]),
    }
    shutil.rmtree(spec["train_dir"])  # the checkpoints: ~220 MB
    shutil.rmtree(os.path.join(tmp, "single"))
    return out


@pytest.fixture(scope="module")
def trainer_run(tree, tmp_path_factory):
    return shared(tmp_path_factory, "torch_parallel_trainer",
                  lambda: _trainer_run(tree, tmp_path_factory.mktemp("parallel_trainer")))


def test_data_parallel_trainer_logs_the_single_process_losses(trainer_run):
    _assert_logs_equal(trainer_run["dp_log"], trainer_run["single_log"])


def test_only_rank_zero_prints_and_writes(trainer_run):
    rank0, rank1 = trainer_run["outputs"]
    assert [line.split()[1] for line in rank0.splitlines() if line.startswith("step ")] == [
        str(s) for s in range(1, STEPS + 1)]
    assert not [line for line in rank1.splitlines() if line.startswith(("step ", "epoch"))]
    files = trainer_run["files"]
    assert [f for f in files if f.startswith("ckpt_")] == [f"ckpt_{STEPS:08d}.pt"]
    # rank 0's two trainers (the run, the restore) each open an event file; rank 1 none
    writers = {f.split(".")[-2] for f in files if f.startswith("events.out.tfevents")}
    assert len(writers) == 1
    assert files.count("train_metrics.jsonl") == 1


def test_two_rank_restore_is_bit_equal(trainer_run):
    assert trainer_run["counts"] == [(STEPS, STEPS), (STEPS, STEPS)]
    assert trainer_run["restored_equal"] == [True, True]
    assert trainer_run["ranks_equal"] and trainer_run["n_traces"] > 0


def test_indivisible_global_batch_fails_on_both_ranks(tree, tmp_path):
    """Three images on two ranks: both raise, and neither waits for the other."""
    cfg = _tiny_cfg()
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    batch = (rng.randn(4, 128, 128, 3).astype(np.float32), np.full((4, 2), 128, np.int32),
             np.tile(np.asarray([[[10, 10, 80, 90]]], np.float32), (4, 1, 1)),
             np.ones((4, 1), bool), np.full((4, 1), 3, np.int32))
    draws = det.sample_draws(torch.Generator(), 4, (128, 128))
    save_inputs(str(tmp_path / "inputs.npz"), batch, draws)
    spec = dict(mode="indivisible", model_type="faster_rcnn", backbone="resnet50", cfg=cfg,
                inputs=str(tmp_path / "inputs.npz"), train_dir=str(tmp_path / "logs"))
    results = run_ranks(spec, tmp_path, timeout_s=120.0, expect_ok=False)
    for rc, out in results:
        assert rc != 0 and "ValueError: global batch 3 not divisible by 2" in out, out[-2000:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_cmd(records_dir, logs_dir, *flags):
    cmd = [sys.executable, "-m", f"{PKG}.train", "--model_type", "faster_rcnn",
           "--tf_records_dir", records_dir, "--logs_dir", logs_dir, "--epochs", "1",
           "--steps_per_epoch", str(STEPS), "--logging_every_n_steps", "1",
           "--summary_every_n_steps", "1", "--saving_every_n_steps", str(STEPS),
           "--device", "cpu", *flags]
    for ov in TINY:
        cmd += ["--config_override", ov]
    return cmd


def _cli_run(tree, tmp):
    root, _ = tree
    records = os.path.join(root, "tfrecords")
    single = _train_cmd(records, os.path.join(tmp, "single"), "--batch_size", "2")
    for attempt in range(2):
        port = _free_port()
        logs = os.path.join(tmp, f"multihost{attempt}")
        cmds = [_train_cmd(records, logs, "--batch_size", "1", "--multihost",
                           "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
                           "--process_id", str(r)) for r in range(2)]
        if attempt == 0:
            cmds.append(single)
        try:
            results = run_processes(cmds, os.path.join(tmp, f"logs{attempt}"), TIMEOUT_S)
            break
        except AssertionError as exc:
            if attempt or "EADDRINUSE" not in str(exc) and "already in use" not in str(exc):
                raise
    out = {"outputs": [out for _, out in results[:2]], "dp_log": _metric_log(logs),
           "single_log": _metric_log(os.path.join(tmp, "single"))}
    shutil.rmtree(tmp)  # the checkpoints: ~220 MB
    return out


def test_train_multihost_command_line_logs_the_single_process_losses(tree, tmp_path_factory):
    got = shared(tmp_path_factory, "torch_parallel_train_cli",
                 lambda: _cli_run(tree, str(tmp_path_factory.mktemp("parallel_cli"))))
    _assert_logs_equal(got["dp_log"], got["single_log"])
    rank0, rank1 = got["outputs"]
    assert sum(line.startswith("step ") for line in rank0.splitlines()) == STEPS
    assert not [line for line in rank1.splitlines() if line.startswith("step ")]


def _eval_detector(cfg):
    """Seeded weights for eval on "tf" pixels ([-1, 1]), the RoI score layer
    scaled by 10 so that the random head's class scores spread."""
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=3)
    with torch.no_grad():
        det.roi_head.roi_head_score.weight.mul_(10.0)
    return det


def _eval_coco_both(tmp):
    coco_rehearsal.generate(str(tmp), 0, 4, seed=5)
    cfg = _tiny_cfg("coco")
    save_params(str(tmp / "params.npz"), _eval_detector(cfg))
    stats, results = {}, {}
    for n in (0, 2):
        argv = [str(tmp / "params.npz"), "--annotation_file", str(tmp / "instances_val.json"),
                "--image_dir", str(tmp / "images"), "--batch_size", "2", "--data_parallel", str(n),
                "--results_json", str(tmp / f"dp{n}.json"), "--preprocessing_type", "tf",
                "--device", "cpu"]
        for ov in [ov for ov in TINY if not ov.startswith("scales=")] + ["scales=[1, 2, 4, 8]"]:
            argv += ["--config_override", ov]
        with contextlib.redirect_stdout(io.StringIO()):
            stats[n] = list(eval_coco.main(argv))
        results[n] = (tmp / f"dp{n}.json").read_bytes()
    return stats, results


def test_eval_coco_data_parallel_gives_the_same_stats(tmp_path):
    """Batches of 2 against shards of 1: the CPU's convolutions at B = 1 and
    B = 2 differ in the last bits, so the results JSON is held within 1e-6
    (scores absolute, boxes relative to the largest coordinate; observed
    5.4e-7 and 2.1e-4 px of ~800) and the 12 stats equal."""
    stats, results = _eval_coco_both(tmp_path)
    assert len(stats[0]) == 12 and stats[2] == stats[0]
    got, want = json.loads(results[2]), json.loads(results[0])
    assert want and [(r["image_id"], r["category_id"]) for r in got] == [
        (r["image_id"], r["category_id"]) for r in want]
    scale = max(max(np.abs(r["bbox"])) for r in want)
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose([r["bbox"] for r in got], [r["bbox"] for r in want],
                               rtol=0, atol=1e-6 * scale)


def test_prediction_files_data_parallel_byte_identical(tree, tmp_path):
    root, _ = tree
    voc = os.path.join(root, "VOCdevkit", "VOC2007")
    cfg = _tiny_cfg()
    det = _eval_detector(cfg)
    main = os.path.join(voc, "ImageSets", "Main")
    with open(os.path.join(main, "test.txt")) as f:
        first = f.read().split()[:8]
    with open(os.path.join(main, "dp.txt"), "w") as f:
        f.write("\n".join(first) + "\n")
    blobs = {}
    for n in (0, 2):
        iterator, ids = pascal_eval_iterator(voc, "dp", cfg, "tf", num_workers=1)
        out = tmp_path / f"dp{n}"
        out.mkdir()
        paths = get_prediction_files(det, iterator, ids, str(out / "{:s}.txt"), batch_size=4,
                                     data_parallel=n, devices=["cpu", "cpu"] if n else None)
        blobs[n] = [open(p, "rb").read() for p in paths]
    assert len(blobs[0]) == 20 and sum(map(len, blobs[0])) > 0
    assert blobs[2] == blobs[0]


@pytest.mark.parametrize("entry", ["train", "eval_pascal", "infer", "Trainer"])
def test_spatial_partition_refuses_naming_item_8c(entry, tmp_path, monkeypatch):
    """Spatial partitioning (ROADMAP item 8(c)) is ported: each entry point
    refuses N = 2 without a process group, naming torchrun, and with a
    world size of 3, which 2 does not divide, before any collective."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)

    def call():
        if entry == "train":
            train_cli.main(["--spatial_partition", "2", "--device", "cpu"])
        elif entry == "eval_pascal":
            eval_pascal.main(["x.npz", "--root_path", ".", "--spatial_partition", "2",
                              "--device", "cpu"])
        elif entry == "infer":
            infer_cli.main(["x.npz", "x.jpg", "--spatial_partition", "2", "--device", "cpu"])
        else:
            Trainer(None, str(tmp_path), spatial_partition=2)

    with pytest.raises(RuntimeError, match="torchrun"):
        call()
    if entry == "Trainer":  # a group of one process
        from tf_eager_object_detection_tpu_torch.parallel import multihost

        multihost.initialize(device="cpu", timeout_s=60)
        try:
            with pytest.raises(ValueError, match="does not divide the world size 1"):
                call()
        finally:
            multihost.shutdown()
    else:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "3")
        with pytest.raises(ValueError, match="does not divide the world size 3"):
            call()
