#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It imports nothing of JAX.

1. Prints the card's name and power limit; requires CUDA; turns TF32 off.
2. Builds the three CUDA libraries from `tf_eager_object_detection_tpu_torch/csrc`
   at once (one nvcc each: NMS, RoIAlign forward, RoIAlign backward), with
   a fourth: the backward with a device counter of the reductions it
   issues (`counting_source`, a diagnostic build that only reads the
   counts), and prints their ptxas reports.
3. K1, the NMS kernel, against its plain PyTorch version: index-exact at the
   Faster R-CNN shapes ([1, 6000] -> 300 for `predict`, [4, 6000] -> 300 for
   a served batch, [20, 300] -> 50 per class), the FPN shapes ([4, 6000] ->
   1000, [20, 1000] -> 50), a cluster-heavy fixture with padded slots
   ([1, 12000] -> 2000, the training RPN NMS) and the COCO per-class shape
   ([80, 300] -> 100: every row at the cap, then, with 7 slots in 10
   invalid, none). Kernel times come from
   CUDA-graph replays (`graph_ms`: the wrappers' host work is not replayed,
   so a kernel shorter than its launch is still timed by the card), the
   plain versions' from CUDA events around their calls. Then the
   word-blocked scan's edge cases, index-exact: the cap inside a word and
   at a word's end, K not a multiple of 64, K = 1, every slot invalid,
   every box identical, no overlaps with the cap reached early or never,
   IoUs exactly at the threshold.
4. K4, the fused-pyramid RoIAlign kernel, against its plain version within
   atol/rtol 1e-5 on N(0, 1) features: the served shape (B=4, N=1000, the
   four planes of a 640x1024 bucket, image extents below the bucket), the
   `predict` shape (B=1), a fixture with invalid rois, rois on the valid
   extent's edge and a roi of aspect > 10, the training shape (B=1,
   N=256), C = 42 (not a multiple of 4) and planes 4 bytes off a 16-byte
   boundary (both on the kernel's scalar path), and image extents past the
   planes (a tap past a plane weighs 0); times of the kernel, the plain
   version (one image at a time) and, as a near-equivalent reference only,
   `grid_sample` over the four levels.
5. K5 (the fused-pyramid backward), K3 (the single-level backward, one
   launch per level) and K2 (the single-level forward, one launch per level)
   against their plain versions at the stock training shape (B=1, N=256),
   at B=4, and on an overlap-heavy and an edge / invalid / aspect-30
   fixture and at image extents past the planes, with N(0, 1) g; K5 and K3
   also at B=1 with the training path's
   pool-sparse g (the 2x2 max pool's backward): each backward cell within
   1e-5 of sum |g * w| over its terms (float reductions add in no fixed
   order), K2 within atol/rtol 1e-5; errors, times from graph replays,
   bounds, the (tap, channel) terms the backward adds, and the reductions
   it issues (vector and scalar) as the counting build counts them, which
   must equal the count of a model of its walk (`backward_work`);
   `grid_sample` (its autograd backward for K5 / K3) per level as a
   near-equivalent reference only.
   Then the bf16-plane variants (the planes of bfloat16 compute): K4 at the
   served shape, the training shape, the edge / invalid / aspect fixture,
   C = 42 and planes 2 bytes off a 16-byte boundary, and K2 per level at the
   training shape, each bit-equal to the same kernel on the planes widened
   to float32 and within 1e-5 of the plain version; K5 and K3 for bf16
   planes at B=1 (N(0, 1) and pool-sparse g) and B=4: the float32
   accumulators within 1e-5 of sum |g * w|, the returned bf16 planes equal
   to them rounded; graph-replay times (the backward's with the zeroing and
   the cast, and the cast alone) beside the float32 variants', bounds from
   the bf16 bytes, and `grid_sample` (its autograd backward for K5 / K3) on
   the same bf16 planes as a near-equivalent reference only.
6. Faster R-CNN ResNet-50 serving, then FPN ResNet-50 serving, each at full
   width with seeded random weights and the stock Pascal config: 8 synthetic
   VOC-sized requests through `preprocess_eval_image` -> `batched_im_detect`
   (batch 4) -> `post_ops_prediction`, plus one `predict`. Checks shapes,
   finiteness, boxes inside the image, and that every NMS and RoIAlign of
   the path went through the kernels (launch counts set to 0 before each
   path and read after it). Holds `predict` on the card against the port's
   CPU path on a small input. Prints each model's batch time, stages, one
   profiled call and peak memory. Then both again with bfloat16 compute
   (`tpu_compute_dtype`; paths `faster_rcnn_bf16`, `fpn_bf16`): K1 and,
   for FPN, K4's bf16 variant launched as configured, detections finite
   with float32 scores, the backbone output within rel.mean() < 0.05 of the
   float32 detector of the same seed, and the figures beside float32's.
   Faster R-CNN VGG16 takes the same path in both dtypes (`frcnn_vgg16`,
   `frcnn_vgg16_bf16`; K1 only, its `predict` against the CPU on
   caffe-scaled pixels). Then one served batch of 4 (K1 for the batch and
   for each image, FPN K4 once) of Faster R-CNN and FPN at ResNet-101 and
   ResNet-152, float32, their frozen BatchNorms set to the batch's
   statistics first (`frcnn_resnet101`, `fpn_resnet101`, `frcnn_resnet152`,
   `fpn_resnet152`), and FPN with `tpu_fpn_backbone_style: "slim"`:
   `predict` and one training loss and backward against the CPU, one
   served batch (`fpn_slim`) and one B=1 training step (`fpn_slim_train_b1`,
   K1, K4, K5). Then Faster R-CNN ResNet-50 with the COCO config (12
   anchors a cell, 81 classes, caps of 100), float32 and bf16, on the same
   requests (`frcnn_coco`, `frcnn_coco_bf16`; `predict` against the CPU
   with four anchor scales at the small input). Every serving path checks
   K1's launches by shape too: [4, 6000] a batch, [1, 6000] for `predict`,
   one class-batched NMS an image (COCO: [80, 300] -> 100).
7. FPN ResNet-50 training, then Faster R-CNN ResNet-50 (C4) training, each
   with the stock config, full width, seeded random weights: one loss +
   backward on the card, with cuDNN off and then on, against the port's CPU
   path (128x128, same weights and draws); then `preprocess_train_image` ->
   `make_train_step` for 8 steps at B=1 (landscape and portrait
   interleaved) and 3 at B=4 (paths `fpn_train_b1`, `fpn_train_b4`,
   `frcnn_train_b1`, `frcnn_train_b4`), and for FPN 2 at B=1 with
   `tpu_roi_align_fused_levels` False; each path's launch counts set to 0
   before and checked after (per step: FPN K1 1, K4 1, K5 1 fused, K1 1, K2
   4, K3 4 per level; Faster R-CNN K1 1, its RoI crop being two matmuls);
   losses finite, sample counts as configured; step times, stages, one
   profiled B=1 step of each path, peak memory and conv + linear work per
   step; the frozen parameters unchanged after the steps. Faster R-CNN
   VGG16 likewise (`frcnn_vgg16_train_b1`, `_b4`, `VGG16_STEPS`; the
   draws of the card-vs-CPU step carry the dropout masks; blocks 1-2
   frozen), and C4 with the COCO config (`frcnn_coco_train_b1`, `_b4`,
   `COCO_STEPS`; its card-vs-CPU step with anchor scales (1, 2, 4, 8)).
   Then all three with bfloat16 compute (`fpn_bf16_train_b1` and
   the rest, `BF16_STEPS` or `VGG16_STEPS` steps each): one loss and
   backward on the card
   against the port's CPU bf16 path (the CPU step's proposals pinned,
   losses rtol 2e-2, gradient cosines), the bf16 variants of K4 / K5 and
   K2 / K3 launched as configured, parameters and momentum float32 after
   the steps, and the peak memory of a C4 B=4 step without and with
   `tpu_remat`.
8. `frcnn_voc_eval`: the VOC eval path on the card. A synthetic VOC layout
   (annotation XMLs and `ImageSets/Main/test.txt`, the 8 requests with 1-8
   seeded boxes each) in a temporary directory; the images go to
   `preprocess_eval_image` as arrays (JPEG decoding is held against JAX on
   the CPU, tests/test_torch_voc_data.py); `get_prediction_files` (batch 4)
   -> per-class result files ->
   `voc_eval` against the XMLs. Checks K1 once per batch (the RPN NMS) and
   once per image (`eval_post_process`, the 20 classes in one call), that
   the files parse back, a finite mAP in [0, 1], and AP exactly 1.0 for
   every class present when the ground truth is written as detections.
9. `frcnn_trainer`, then `fpn_trainer`: the trainer path at full width
   (stock Pascal config at the rehearsal's learning rate 2.5e-4, B=1). The
   port's `voc_rehearsal.generate` writes 16 trainval and 16 test 600x800
   procedural JPEGs to a temporary directory and `create_pascal_tf_records`
   their TFRecords; `Trainer.train` takes 12 steps over
   `dataset_factory("pascal", "train", ...)` through `prefetch` and saves a
   checkpoint (launches: the steps' and the summary step's `predict`). A
   fresh `Trainer` on the same directory must restore bit-equal parameters,
   momentum traces and step count, and one more step of both on one batch
   and one set of draws must give equal losses. `eval_pascal.main` from the
   checkpoint over the test JPEGs (`pascal_eval_iterator` ->
   `get_prediction_files` -> `voc_eval`) must write 20 result files and 20
   APs in [0, 1] (K1 once a batch and once an image, FPN K4 once a batch).
   Prints the median step wall time with the input pipeline beside the
   bare step's of phase 7, and a profile of 4 trainer steps: wall, device
   busy, idle share, the host's wait for the next batch and the kernels
   launched a step. Then `frcnn_coco_trainer` and `frcnn_coco_eval`: the
   port's `coco_rehearsal.generate` writes 16 train and 16 val procedural
   600x800 JPEGs and their instances JSONs; `Trainer.train` takes 12 steps
   over `dataset_factory("coco", "train", ...)` with the COCO config, and a
   fresh `Trainer` restores the checkpoint bit-equal; `eval_coco.main` from
   it writes a results JSON that parses back and 12 stats in [-1, 1] (K1
   once a batch and once an image at [80, 300] -> 100); from the untrained
   seeded detector's `.npz` it writes results (at most 100 an image) that
   parse back; and the non-crowd ground truth as detections scores AP
   @[.50:.95] exactly 1.0.
10. The reference checkpoint importers, Adam and the debug entry points.
   `import_frcnn_tf`, `import_vgg16_tf`, `import_fpn_tf`: a synthetic
   tf-faster-rcnn ResNet-50 / VGG16 and FPN_Tensorflow ResNet-50 checkpoint
   (seeded, built from the port's name maps in the reference's layouts:
   HWIO, slim convs without biases, VGG16's fc6 as [7, 7, 512, 4096] and
   fc7 as [1, 1, 4096, 4096]; He-scaled, positive variances) goes through
   `importers.apply_name_map` into a full-width detector on the card (VGG16
   first takes a slim `vgg_16` backbone with the conv1 BGR flip); every
   state_dict entry must be bit-equal to its value derived without the
   importer; `predict` on the card against the port's CPU path on the same
   weights; the 8 requests served at batch 4 (FPN with image_format "rgb"),
   K1 and FPN's K4 counted. The machine has no h5py or tensorflow, so their
   readers are not run (the smoke says so); `import_pth`: a `torch.save`d
   state_dict through `convert_pth_to_dict` and `load_pickle_dict` and back
   into a detector, bit for bit. `adam`: one FPN Adam step at 128x128 on
   the card against the CPU, then `ADAM_STEPS` full-size FPN B=1 steps with
   `optimizer_type='adam'` (K1, K4, K5 counted; `fpn_adam_train_b1`).
   `debug`: `predict_rpn` / `predict_roi` (C4) and `predict_rpns` /
   `predict_rois` (FPN) on the card against the CPU with the same draws,
   and a `make_train_step(with_probe=True)` step's probe against the
   host's sum. Every card-vs-CPU training check (phase 7's float32 ones and
   the Adam one) first measures its own conditioning: the CPU step at the
   input times 1 + 1e-6 must move no gradient by more than the tolerance,
   and the move prints beside the card-vs-CPU gap.
11. `export_frcnn_baked`, `export_fpn_program_only`: the serving export
   (`serving/export.py`). C4 ResNet-50 float32 (TF32 off) is exported with
   its weights baked for both buckets (608x1008, 1008x608), FPN ResNet-50
   float32 program only (`bake_params=False`: 640x1024 and 1024x640, and
   one `params.npz`); each artifact is reloaded with `load_predict` and
   serves the 8 requests, held against the detector's direct `predict`
   (labels and validity equal, boxes within 1e-4 px, scores within 1e-5;
   the largest differences print). K1 launches twice a request through
   both programs, K4 once a request through FPN's. Prints the export
   seconds of each artifact, the files' sizes, the load seconds, one
   request through the artifact against the direct call, and the host
   microseconds of one call through the K1 and K4 operators against a
   direct call of their ctypes wrappers at the served shapes.
12. Data parallelism (`parallel/{multihost,mesh}.py`). `fpn_ddp_nccl_w1`:
   `Trainer(data_parallel=True)` over an NCCL group of one process (FPN
   ResNet-50, stock Pascal config, full width, float32 with TF32 off) takes
   2 steps over the batches and draws of plain `Trainer`s; its updates
   must differ from the nearest of 3 plain runs', in norm, by no more than
   3 times the plain runs' own spread (K5's atomics), both printed; K1, K4
   and K5 once a step. `fpn_dp2_train`: two processes (this script with `--dp-rank R
   SPEC`, started with a deadline, killed at it), b = 1 each at full width,
   over gloo with CUDA tensors on cuda:0 (NCCL refuses two ranks on one
   GPU; NCCL over cuda:0 and cuda:1 where `torch.cuda.device_count()` >= 2),
   against one process at B = 2 from the same weights (frozen BatchNorms
   calibrated, the RPN score layer x20), batch and global draws: losses
   within rtol 1e-4, counts equal, the updates within GRAD_TOL of their norm
   and each tensor's within GRAD_TOL of its largest value (or twice what a
   1e-6 change of the input moves it: phase 7's conditioning, printed), the
   ranks' parameters bit-equal, K1, K4 and K5 once on each rank; each
   rank's step time, and its time without the gradient all-reduce (DDP's
   `no_sync`). `frcnn_eval_dp2`, `fpn_eval_dp2`: `batched_im_detect` and
   `get_prediction_files` with `data_parallel=2` over two replicas on
   [cuda:0, cuda:0] at batch 4 against one device at batch 2 (the shards'
   shape) on the 8 requests: validity equal, boxes within 1e-4 px, scores
   within 1e-5; K1 once a shard and once an image, FPN's K4 once a shard;
   the current CUDA device unchanged.
13. Spatial partitioning (`parallel/spatial.py`). Two processes (this
   script with `--sp-rank R SPEC`, started with a deadline, killed at it)
   over gloo with CUDA tensors on cuda:0 (NCCL over cuda:0 and cuda:1 where
   there are two GPUs) build a space group of both and shard each image's
   rows over it. `frcnn_sp2_train` (C4 ResNet-50, 608x1008) and
   `fpn_sp2_train` (FPN ResNet-50, 640x1024), stock Pascal config, float32
   with TF32 off, B = 1: one step of each against one process at B = 1
   from the same weights (frozen BatchNorms calibrated, the RPN score layer
   x20, as phase 12) and draws: losses within rtol 1e-4 on each rank (or,
   where the input x (1 + 1e-6) moves one process's loss by more, within
   twice that move: a random full-width point whose proposals reorder at
   the last bit; each gap and move prints), counts equal, the updates held
   as phase 12's (GRAD_TOL of their norm and of each tensor's largest
   value, or twice phase 7's conditioning move), the ranks' parameters
   bit-equal, K1 (and FPN's K4 and K5) once on each rank; each rank's step
   time, the bytes its halo exchanges and its gather move a step, and
   those exchanges replayed alone. `frcnn_sp2_predict`: one request
   through the spatial `predict` on each rank: the gathered stride-16 map
   within SP_MAP_TOL of the unsharded extractor's largest value, and
   against the detector's own `predict` validity and labels equal (phase
   12's eval checks), boxes within 0.05 px and scores within JAX's spatial
   tolerance (rtol 1e-4, atol 1e-5), K1 twice; times and exchanges.
14. Prints a JSON line with the records of the five kernels and of the four
   RoIAlign kernels' bf16-plane variants (K1's with every shape of phase
   3 under `per_shape`), then as its last line
   `{"ok": true, "device": {...}}`. Any failure raises: exit code != 0.

The port trains on several GPUs with `torchrun --standalone
--nproc_per_node=N -m tf_eager_object_detection_tpu_torch.scripts.train
--data_parallel ...` on one host, and with `python -m
tf_eager_object_detection_tpu_torch.scripts.train --multihost
--coordinator_address HOST:PORT --num_processes P --process_id R ...` (or
torchrun's environment) on several; `eval_pascal` / `eval_coco`
`--data_parallel N` split each batch over the first N GPUs; `train`,
`eval_pascal` and `infer` under `torchrun --standalone --nproc_per_node=N`
with `--spatial_partition N` shard each image's rows over the N GPUs.

Every kernel check of phases 3-5 also calls the kernel through its
`tf_eager_od` operator (`ops/kernels/library.py`): K1, K4 and K2 bit-equal
to their wrappers, K5 and K3 as the operators' `register_autograd` backward
within the wrappers' tolerance of the plain backward. The paths of phases
6-13 reach every kernel through the operators.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.coco import CocoDataset
from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
from tf_eager_object_detection_tpu_torch.data.preprocessing import (
    preprocess_eval_image,
    preprocess_train_image,
)
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.evaluation.coco_eval import evaluate_coco_detections
from tf_eager_object_detection_tpu_torch.evaluation.pascal_eval_files import (
    eval_post_process,
    get_prediction_files,
    write_voc_detection_files,
)
from tf_eager_object_detection_tpu_torch.evaluation.voc_eval import voc_eval
from tf_eager_object_detection_tpu_torch.models.backbones.vgg import VGG16_HIDDEN
from tf_eager_object_detection_tpu_torch.models.layers import FrozenBatchNorm
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as nms_mod
from tf_eager_object_detection_tpu_torch.ops import roi_align as roi_mod
from tf_eager_object_detection_tpu_torch.ops.kernels import build as kb
from tf_eager_object_detection_tpu_torch.ops.kernels import library as op_lib
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL,
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
    CudaRoiAlignBackward,
)
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    ROI_ALIGN_KERNEL,
    ROI_ALIGN_SINGLE_KERNEL,
    vectorizable,
)
from tf_eager_object_detection_tpu_torch.ops.prediction import post_ops_prediction
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.parallel import multihost
from tf_eager_object_detection_tpu_torch.parallel.mesh import make_parallel_train_step, replicate
from tf_eager_object_detection_tpu_torch.parallel.spatial import (
    RowShard,
    make_spatial_groups,
    make_spatial_predict,
    make_spatial_train_step,
    sharded_extractor,
)
from tf_eager_object_detection_tpu_torch.ref_import import (
    from_jax,
    importers,
    name_maps,
    pytorch_convert,
)
from tf_eager_object_detection_tpu_torch.scripts import eval_coco, eval_pascal
from tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal import COCO_CAT_IDS
from tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal import generate as generate_coco
from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import generate
from tf_eager_object_detection_tpu_torch.serving.export import export_predict, load_predict
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params
from tf_eager_object_detection_tpu_torch.training.optimizer import AdamOptimizer, make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer, prefetch

BATCH = 4
# VOC-like raw sizes (h, w), landscape and portrait interleaved
REQUEST_SIZES = [(375, 500), (500, 375), (333, 500), (500, 333),
                 (375, 500), (500, 366), (366, 500), (500, 375)]
NMS_CASES = [  # (name, batch, boxes, max_output, iou threshold)
    ("rpn", 1, 6000, 300, 0.7),
    ("rpn_batch", BATCH, 6000, 300, 0.7),  # the RPN NMS of one served Faster R-CNN batch
    ("per_class", 20, 300, 50, 0.3),
    ("fpn_rpn_batch", BATCH, 6000, 1000, 0.7),  # the RPN NMS of one served FPN batch
    ("fpn_per_class", 20, 1000, 50, 0.3),
    ("cluster_padded", 1, 12000, 2000, 0.7),
    # the class-batched NMS of one COCO image (80 foreground classes, caps of
    # 100): the cap reached in every row, then (7 slots in 10 invalid) in none
    ("coco_per_class", 80, 300, 100, 0.3),
    ("coco_per_class_uncapped", 80, 300, 100, 0.3),
]
NMS_MAIN = "fpn_rpn_batch"
# a case's own fixture seed and arguments (the earlier cases share one
# generator, in order), and whether its rows reach the cap (most / none)
NMS_FIXTURE_ARGS = {"coco_per_class": dict(seed=80),
                    "coco_per_class_uncapped": dict(seed=81, invalid=0.7)}
NMS_AT_CAP = {"coco_per_class": True, "coco_per_class_uncapped": False}
# edge cases of the word-blocked scan (64 boxes a word), index-exact, not timed:
# (name, batch, boxes, max_output, iou threshold, fixture)
NMS_EDGE_CASES = [
    ("cap_mid_word", 1, 300, 37, 0.5, "cluster"),
    ("cap_at_word_boundary", 1, 256, 128, 0.5, "disjoint"),  # 128th kept = last of word 1
    ("k_not_word_multiple", 2, 201, 150, 0.6, "cluster"),
    ("k_one", 1, 1, 1, 0.5, "cluster"),
    ("all_invalid", 1, 130, 20, 0.5, "invalid"),
    ("all_identical", 1, 200, 50, 0.7, "identical"),  # one kept
    ("no_overlaps_cap_early", 1, 500, 100, 0.3, "disjoint"),
    ("no_overlaps_cap_beyond_k", 3, 700, 1000, 0.3, "disjoint"),
    # integer boxes on a small grid: many IoUs fall exactly on the threshold
    ("threshold_ties_half", 2, 500, 300, 0.5, "grid"),
    ("threshold_ties_third", 2, 500, 300, 1.0 / 3.0, "grid"),
    ("threshold_ties_0.7", 2, 500, 300, 0.7, "grid"),
]
FPN_STRIDES = (4, 8, 16, 32)
FPN_BUCKET = (640, 1024)
# image extents past the bucket's planes: the last valid cell of every level
# lies past the plane's last, where a tap weighs 0
PAST_THE_PLANES = [[700, 1100], [656, 1040]]
CROP = 14
# NVIDIA H100 SXM, published: HBM bytes/s and float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate
NMS_OPS_PER_IOU = 15  # float ops of one IoU test in csrc/nms.cu::overlaps
ROI_OPS_PER_SAMPLE = 9  # 6 multiplies and 3 adds per sample and channel
BWD_OPS_PER_TAP = 2  # a multiply and an add per nonzero tap and channel
TRAIN_ROIS = 256  # roi_total_sample_number of the stock config
# the bare B=1 training step's median recorded in PERF.md before the trainer
# existed (H100 80GB HBM3, 700 W), printed beside the trainer's
RECORDED_BARE_STEP_MS = {"fpn": 57.96, "frcnn": 51.00}
# the kernels of the port: launch counter, the plane dtype of the variant
# (the wrappers count launches by it) and the TPU kernel it replaces
_PALLAS = "tf_eager_object_detection_tpu/ops/pallas/"
KERNELS = {
    "nms_alive_sorted": (NMS_KERNEL, "float32", _PALLAS + "nms_pallas.py:28"),
    "roi_align_single_level": (ROI_ALIGN_SINGLE_KERNEL, "float32",
                               _PALLAS + "roi_align_pallas.py:67"),
    "roi_align_single_level_backward": (ROI_ALIGN_SINGLE_BACKWARD_KERNEL, "float32",
                                        _PALLAS + "roi_align_pallas.py:176"),
    "roi_align_multilevel": (ROI_ALIGN_KERNEL, "float32", _PALLAS + "roi_align_pallas.py:664"),
    "roi_align_multilevel_backward": (ROI_ALIGN_BACKWARD_KERNEL, "float32",
                                      _PALLAS + "roi_align_pallas.py:759"),
    # the bf16-plane variants (bfloat16 compute): the same wrappers and sources
    "roi_align_single_level_bf16": (ROI_ALIGN_SINGLE_KERNEL, "bfloat16",
                                    _PALLAS + "roi_align_pallas.py:67"),
    "roi_align_single_level_backward_bf16": (ROI_ALIGN_SINGLE_BACKWARD_KERNEL, "bfloat16",
                                             _PALLAS + "roi_align_pallas.py:176"),
    "roi_align_multilevel_bf16": (ROI_ALIGN_KERNEL, "bfloat16",
                                  _PALLAS + "roi_align_pallas.py:664"),
    "roi_align_multilevel_backward_bf16": (ROI_ALIGN_BACKWARD_KERNEL, "bfloat16",
                                           _PALLAS + "roi_align_pallas.py:759"),
}


# the `tf_eager_od` operator (ops/kernels/library.py) through which the
# port calls each kernel
OPERATORS = {
    "nms_alive_sorted": "tf_eager_od::nms_alive_sorted",
    "roi_align_multilevel": "tf_eager_od::roi_align",
    "roi_align_single_level": "tf_eager_od::roi_align (one plane)",
    "roi_align_multilevel_backward": "tf_eager_od::roi_align_backward",
    "roi_align_single_level_backward": "tf_eager_od::roi_align_backward (one plane)",
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def reset_launches() -> None:
    for kernel, _, _ in KERNELS.values():
        kernel.reset_launches()


def launch_counts() -> dict:
    """Launches of each kernel variant since `reset_launches`; raises if a
    wrapper counted a launch that no variant accounts for."""
    counts = {name: kernel.launches_by_dtype.get(dtype, 0)
              for name, (kernel, dtype, _) in KERNELS.items()}
    for kernel in {k for k, _, _ in KERNELS.values()}:
        mine = sum(counts[n] for n, (k, _, _) in KERNELS.items() if k is kernel)
        require(mine == kernel.launches, f"{kernel.name}: {kernel.launches} launches, "
                f"by dtype {kernel.launches_by_dtype}")
    return counts


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 5, replays: int = 4) -> float:
    """Device time of one `fn()`: `calls` calls captured in a CUDA graph,
    replayed `replays` times between CUDA events. The wrappers' host work
    (argument checks, ctypes) runs once, at capture, so a kernel shorter
    than its host-side launch is timed by the card, not by the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (replays * calls)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for work that moves `nbytes` and
    does `ops` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the backward's reductions: the lines its diagnostic builds edit
REDUCE_LINES = (
    "__device__ __forceinline__ void reduce_add(float* dst, float v) { atomicAdd(dst, v); }",
    "__device__ __forceinline__ void reduce_add(float4* dst, float4 v) { atomicAdd(dst, v); }",
)


def counting_source(src: str) -> str:
    """csrc/roi_align_backward.cu with a device counter of the reductions it
    issues (scalar, vector), read and zeroed by `roi_align_backward_reductions`;
    the kernel's sums and addresses are unchanged."""
    for k, line in enumerate(REDUCE_LINES):
        if src.count(line) != 1:
            raise ValueError(f"roi_align_backward.cu has no single line {line!r}")
        count = f"atomicAdd(&g_reductions[{k}], 1ull); atomicAdd(dst, v);"
        src = src.replace(line, line.replace("atomicAdd(dst, v);", count))
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ unsigned long long g_reductions[2];\n", 1)
    return src + """
extern "C" int roi_align_backward_reductions(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_reductions, sizeof(g_reductions));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[2] = {0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_reductions, zero, sizeof(zero)));
}
"""


def build_variant(tag: str, files: dict[str, str], out: Path) -> tuple[ctypes.CDLL, str]:
    """Sources {name: text} written to `out`/`tag` and built with the flags of
    `ops/kernels/build.py` -> (library, compiler output)."""
    d = out / tag
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (d / name).write_text(text)
    lib = d / "lib.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(lib),
           *(str(d / n) for n in files if n.endswith(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib.resolve())), proc.stdout + proc.stderr


def attach(kernel, lib):
    """The wrapper `kernel` launching from `lib` instead of its own build."""
    fn = getattr(lib, kernel.entry)
    fn.argtypes, fn.restype = list(kernel.argtypes), ctypes.c_int
    err = getattr(lib, kernel.error_fn)
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kernel._lib, kernel.build_info = lib, {}
    return kernel


def build_kernels() -> CudaRoiAlignBackward:
    """The three libraries and the counting backward built at once (nvcc
    runs outside the GIL); the single-level wrappers then load the libraries
    of their fused twins. Returns the counting backward's wrapper, which is
    none of the path's: its launches count nowhere."""
    kernels = (NMS_KERNEL, ROI_ALIGN_KERNEL, ROI_ALIGN_BACKWARD_KERNEL)
    counting = {name: (kb.CSRC_DIR / name).read_text()
                for name in CudaRoiAlignBackward.sources}
    counting["roi_align_backward.cu"] = counting_source(counting["roi_align_backward.cu"])
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        counted = pool.submit(build_variant, "backward_counting", counting,
                              kb.BUILD_DIR / "variants")
        infos = list(pool.map(lambda k: k.load(), kernels))
        lib, log = counted.result()
    for kernel, info in zip(kernels, infos):
        print(f"{kernel.name} kernel: {'built' if info['built'] else 'loaded'} {info['path']} "
              f"in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    print("backward with a reduction counter: built; ptxas:",
          "; ".join(ln.strip() for ln in log.splitlines() if "registers" in ln))
    ROI_ALIGN_SINGLE_KERNEL.load()
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL.load()
    lib.roi_align_backward_reductions.argtypes = [ctypes.c_void_p]
    lib.roi_align_backward_reductions.restype = ctypes.c_int
    return attach(CudaRoiAlignBackward(), lib)


def counted_reductions(counting, g, args_list) -> dict:
    """The reductions the backward issues on these inputs, one launch per
    element of `args_list`, as its counting build counts them."""
    buf = (ctypes.c_ulonglong * 2)()
    require(counting._lib.roi_align_backward_reductions(buf) == 0, "zeroing the counter failed")
    for args in args_list:
        counting(g, [tuple(p.shape) for p in args[0]], *args[1:])
    torch.cuda.synchronize()
    require(counting._lib.roi_align_backward_reductions(buf) == 0, "reading the counter failed")
    return {"vector": int(buf[1]), "scalar": int(buf[0])}


# ------------------------------------------------------------------------- K1
def nms_fixture(rng, b, k, cluster=0.4, invalid=0.1):
    """Score-sorted boxes on a 1000x600 canvas: a share of jittered copies of
    a few centers (long suppression chains) and a share of invalid slots."""
    x1 = rng.uniform(0, 1000, (b, k))
    y1 = rng.uniform(0, 600, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, 300, (b, k)),
                      y1 + rng.uniform(8, 300, (b, k))], -1).astype(np.float32)
    n = int(k * cluster)
    for i in range(b):
        centers = boxes[i, rng.choice(k, 64, replace=False)]
        idx = rng.choice(k, n, replace=False)
        boxes[i, idx] = centers[rng.randint(0, 64, n)] + rng.uniform(-6, 6, (n, 4))
    valid = rng.uniform(0, 1, (b, k)) >= invalid
    return boxes, valid


def nms_edge_fixture(rng, b, k, kind):
    """Boxes and validity of an edge case: `cluster` as `nms_fixture`;
    `disjoint` a grid of 10x10 boxes 20 px apart (no pair overlaps);
    `identical` one box repeated; `invalid` every slot off; `grid` boxes
    with integer corners in [0, 12) (IoUs with small denominators)."""
    if kind in ("cluster", "invalid"):
        boxes, valid = nms_fixture(rng, b, max(k, 64))  # 64 cluster centers
        return boxes[:, :k], valid[:, :k] & (kind == "cluster")
    if kind == "grid":
        lo = rng.randint(0, 8, (b, k, 2))
        return (np.concatenate([lo, lo + rng.randint(1, 5, (b, k, 2))], -1).astype(np.float32),
                np.ones((b, k), bool))
    p = np.arange(k)
    if kind == "disjoint":
        one = np.stack([(p % 50) * 20.0, (p // 50) * 20.0, (p % 50) * 20.0 + 10,
                        (p // 50) * 20.0 + 10], -1)
    else:
        one = np.tile([40.0, 50.0, 140.0, 170.0], (k, 1))
    return np.repeat(one[None], b, 0).astype(np.float32), np.ones((b, k), bool)


def nms_bound(boxes, valid, alive, thr):
    """Bound of one NMS call on this data: each input and output byte once;
    the IoU tests greedy NMS needs here (every valid box against the kept
    boxes before it, up to and including its first suppressor)."""
    tests = 0
    pos = torch.arange(boxes.shape[1], device=boxes.device)
    for b in range(boxes.shape[0]):
        kept = torch.nonzero(alive[b]).squeeze(1)
        if kept.numel() == 0:
            continue
        sup = (nms_mod._nms_iou(boxes[b:b + 1, kept], boxes[b:b + 1])[0] > thr) \
            & (kept[:, None] < pos[None, :])
        rank = torch.arange(kept.numel(), device=boxes.device)[:, None].expand_as(sup)
        first = torch.where(sup, rank, torch.full_like(rank, kept.numel())).min(0).values
        before = torch.searchsorted(kept, pos)  # kept boxes ahead of each slot
        tests += int(torch.minimum(before, first + 1)[valid[b]].sum())
    nbytes = boxes.numel() * 4 + valid.numel() + alive.numel()
    return bound(nbytes, tests * NMS_OPS_PER_IOU + boxes.shape[0] * boxes.shape[1] * 3)


def check_nms_kernel(card):
    """Kernel vs plain version at each case; returns {case: record}."""
    rng = np.random.RandomState(0)
    record = {}
    for name, b, k, max_out, thr in NMS_CASES:
        args = dict(NMS_FIXTURE_ARGS.get(name, {}))
        own = np.random.RandomState(args.pop("seed")) if "seed" in args else rng
        boxes, valid = nms_fixture(own, b, k, **args)
        tb = torch.from_numpy(boxes).cuda()
        tv = torch.from_numpy(valid).cuda()
        got = NMS_KERNEL(tb, tv, thr, max_out)
        ref = nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out)
        require(torch.equal(torch.ops.tf_eager_od.nms_alive_sorted(tb, tv, thr, max_out), got),
                f"the NMS operator differs from its kernel's wrapper at {name}")
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        kept = got.sum(-1)
        require(torch.equal(got, ref), f"NMS kernel differs from the plain version at {name}: "
                f"{int((got != ref).sum())} slots")
        require(not bool((got & ~tv).any()) and int(kept.max()) <= max_out,
                f"NMS kernel kept invalid slots or too many at {name}")
        at_cap = float((kept == max_out).float().mean())
        if name in NMS_AT_CAP:
            require(at_cap > 0.5 if NMS_AT_CAP[name] else at_cap == 0.0,
                    f"NMS fixture {name}: share of rows at the cap {at_cap}")
        ms = graph_ms(lambda: NMS_KERNEL(tb, tv, thr, max_out), calls=10)
        plain_ms = cuda_ms(
            lambda: nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out), iters=5, warmup=1
        )
        bound_ms, bound_by = nms_bound(tb, tv, got, thr)
        print(f"nms {name} [{b},{k}]->{max_out} @{thr}: index-exact, kept/row "
              f"{int(kept.min())}..{int(kept.max())} (share at the cap {at_cap:.3f}), "
              f"max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  ({card})")
        record[name] = dict(shape=f"[{b},{k}]->{max_out} @{thr:g}", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    for name, b, k, max_out, thr, kind in NMS_EDGE_CASES:
        boxes, valid = nms_edge_fixture(rng, b, k, kind)
        tb = torch.from_numpy(boxes).cuda()
        tv = torch.from_numpy(valid).cuda()
        got = torch.ops.tf_eager_od.nms_alive_sorted(tb, tv, thr, max_out)
        ref = nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out)
        require(torch.equal(got, ref), f"NMS kernel differs from the plain version at {name}: "
                f"{int((got != ref).sum())} slots")
        print(f"nms edge case {name} [{b},{k}]->{max_out} @{thr}: index-exact, kept/row "
              f"{got.sum(-1).tolist()}  ({card})")
    return record


# ------------------------------------------------------------------------- K4
def roi_fixture(rng, b, n, hws, c=256, invalid=0.02, special=False, overlap=False):
    """Planes of the FPN bucket, N(0, 1); rois inside each image's extent,
    levels by the FPN rule; with `special`, each image's first rois are its
    whole extent, its bottom-right corner and a roi of aspect 30; with
    `overlap`, every roi starts within a 24-pixel square and is 4 to 40
    pixels long (many rois on the same few P2 cells)."""
    planes = [torch.randn(b, -(-FPN_BUCKET[0] // s), -(-FPN_BUCKET[1] // s), c,
                          generator=torch.Generator().manual_seed(s)).cuda()
              for s in FPN_STRIDES]
    hws = np.asarray(hws, np.float32)
    h, w = hws[:, :1], hws[:, 1:]
    if overlap:
        x1 = 100 + rng.uniform(0, 24, (b, n))
        y1 = 60 + rng.uniform(0, 24, (b, n))
        side = rng.uniform(4, 40, (b, n, 2))
    else:
        x1 = rng.uniform(0, 1, (b, n)) * (w - 2)
        y1 = rng.uniform(0, 1, (b, n)) * (h - 2)
        side = np.exp(rng.uniform(np.log(4), np.log(600), (b, n, 2)))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(np.float32)
    if special:
        for i, (hi, wi) in enumerate(hws):
            rois[i, :3] = [[0, 0, wi - 1, hi - 1], [wi - 30, hi - 20, wi - 1, hi - 1],
                           [5, 10, min(605, wi - 1), 30]]
    wh = np.sqrt(np.maximum(rois[..., 2] - rois[..., 0], 0)
                 * np.maximum(rois[..., 3] - rois[..., 1], 0) + 1e-8)
    levels = np.clip(np.floor(4 + np.log2(wh / 224)), 2, 5).astype(np.int64) - 2
    valid = rng.uniform(size=(b, n)) >= invalid
    t = [torch.from_numpy(a).cuda() for a in (rois, levels, valid, hws[:, 0], hws[:, 1])]
    return (planes, *t, CROP, FPN_STRIDES)


def misaligned(args):
    """The fixture with every plane a contiguous view 4 bytes past a 16-byte
    boundary: the kernel takes it on its scalar path."""
    planes = [torch.cat([p.new_zeros(1), p.flatten()])[1:].view(p.shape) for p in args[0]]
    return (planes, *args[1:])


def plain_per_image(args):
    """The plain version one image at a time (its P2 matmul intermediate is
    ~3.7 GB per image at N=1000)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    return torch.cat([roi_mod.roi_align_multilevel_reference(
        [p[i:i + 1] for p in planes], rois[i:i + 1], levels[i:i + 1], valid[i:i + 1],
        ih[i:i + 1], iw[i:i + 1], crop, strides) for i in range(rois.shape[0])])


def roi_bound(args):
    """Bound of one K4 call on these inputs: the output (float32) and the
    small inputs once, the plane cells (in the planes' dtype) that in-range
    samples of valid rois touch once; 9 float ops per in-range sample and
    channel."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    c = planes[0].shape[-1]
    plane_bytes = planes[0].element_size()
    nbytes = rois.shape[0] * rois.shape[1] * crop * crop * c * 4
    nbytes += sum(t.numel() * t.element_size() for t in (rois, levels, valid, ih, iw))
    samples = 0
    for k, (plane, s) in enumerate(zip(planes, strides)):
        h, w = plane.shape[1], plane.shape[2]
        ys, y_ok = roi_mod.level_sample_coords(rois[..., 1], rois[..., 3], ih, s, crop)
        xs, x_ok = roi_mod.level_sample_coords(rois[..., 0], rois[..., 2], iw, s, crop)
        ok = ((levels == k) & valid)[..., None, None] & y_ok[..., :, None] & x_ok[..., None, :]
        samples += int(ok.sum())
        y0 = ys.floor().long()
        x0 = xs.floor().long()
        bidx = torch.arange(rois.shape[0], device=rois.device)[:, None, None, None]
        touched = torch.zeros(rois.shape[0], h, w, dtype=torch.bool, device=rois.device)
        for dy in (0, 1):
            for dx in (0, 1):
                yy = (y0 + dy).clamp_max(h - 1)[..., :, None].expand(ok.shape)
                xx = (x0 + dx).clamp_max(w - 1)[..., None, :].expand(ok.shape)
                touched[bidx.expand(ok.shape)[ok], yy[ok], xx[ok]] = True
        nbytes += int(touched.sum()) * c * plane_bytes
    return bound(nbytes, samples * c * ROI_OPS_PER_SAMPLE)


def level_grids(args):
    """Each level's plane in NCHW and the `grid_sample` grid of every roi's
    sample points on it (align_corners: cell centres at -1 and 1), in the
    plane's dtype (`grid_sample` takes one dtype: a bf16 plane gets its
    sample points rounded to bf16)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    out = []
    for plane, s in zip(planes, strides):
        h, w = plane.shape[1], plane.shape[2]
        ys, _ = roi_mod.level_sample_coords(rois[..., 1], rois[..., 3], ih, s, crop)
        xs, _ = roi_mod.level_sample_coords(rois[..., 0], rois[..., 2], iw, s, crop)
        gy = (ys * (2.0 / (h - 1)) - 1.0)[..., :, None].expand(*ys.shape, crop)
        gx = (xs * (2.0 / (w - 1)) - 1.0)[..., None, :].expand(*xs.shape[:-1], crop, crop)
        grid = torch.stack([gx, gy], -1).reshape(rois.shape[0], -1, crop, 2).contiguous()
        out.append((plane.permute(0, 3, 1, 2).contiguous(), grid.to(plane.dtype)))
    return out


def grid_sample_levels(args):
    """`grid_sample` per level on the same sample points, as a near-equivalent
    reference: it zeroes single taps outside the plane (not whole samples
    outside the valid extent) and takes one level per call. Returns a
    closure over inputs prepared outside the timing."""
    prepared = level_grids(args)
    return lambda: [F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=True) for x, g in prepared]


def check_roi_kernel(card):
    """K4 vs its plain version; returns {case: record}."""
    rng = np.random.RandomState(1)
    cases = [
        ("served", roi_fixture(rng, BATCH, 1000, [[600, 800], [600, 1000], [576, 768], [640, 853]])),
        ("predict", roi_fixture(rng, 1, 1000, [[600, 800]])),
        ("edges_invalid_elongated", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]],
                                                invalid=0.3, special=True)),
        ("train_b1", roi_fixture(rng, 1, TRAIN_ROIS, [[600, 800]], invalid=0.0)),
        ("channels_42", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]], c=42, invalid=0.3,
                                    special=True)),
        ("misaligned_planes", misaligned(roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]],
                                                     invalid=0.3, special=True))),
        ("past_the_planes", roi_fixture(rng, 2, 64, PAST_THE_PLANES, invalid=0.3,
                                        special=True)),
    ]
    record = {}
    for name, args in cases:
        got = ROI_ALIGN_KERNEL(*args)
        path = "float4" if vectorizable(args[0], got) else "scalar"
        require(torch.equal(roi_op(args), got),
                f"the RoIAlign operator differs from its kernel's wrapper at {name}")
        torch.cuda.synchronize()
        ref = plain_per_image(args)
        err = float((got - ref).abs().max())
        rel = float(((got - ref).abs() - 1e-5 * ref.abs()).max())
        valid = args[3]
        require(rel <= 1e-5, f"RoIAlign kernel differs from the plain version at {name}: "
                f"max abs err {err}")
        require(not bool(got[~valid].any()), f"RoIAlign kernel: invalid rois not zero at {name}")
        require(bool(torch.isfinite(got).all()), f"RoIAlign kernel: non-finite at {name}")
        del ref
        ms = graph_ms(lambda: ROI_ALIGN_KERNEL(*args))
        plain_ms = cuda_ms(lambda: plain_per_image(args), iters=2, warmup=1)
        grid_ms = cuda_ms(grid_sample_levels(args), iters=10)
        bound_ms, bound_by = roi_bound(args)
        b, n = args[1].shape[:2]
        print(f"roi_align {name} [B={b}, N={n}, C={args[0][0].shape[-1]}, {path} path]: "
              f"max_abs_err {err:.3g} "
              f"(atol/rtol 1e-5), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), grid_sample x4 levels (near-equivalent "
              f"reference, not the same function) {grid_ms:.4f} ms  ({card})")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, near_reference_ms=grid_ms)
    return record


# --------------------------------------------------------------- K5, K3, K2
def single_level_args(args, k):
    """The fused fixture's level k as single-level arguments: plane k, the
    rois assigned to it (and valid) active."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    return [planes[k]], rois, torch.zeros_like(levels), (levels == k) & valid, ih, iw, crop, \
        (strides[k],)


def per_level(args):
    return [single_level_args(args, k) for k in range(len(args[0]))]


def roi_op(args):
    """K4 through the `tf_eager_od::roi_align` operator (K2 with one plane)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    return torch.ops.tf_eager_od.roi_align(list(planes), rois, levels, valid, ih, iw, crop,
                                           list(strides))


def roi_op_grads(g, args):
    """The planes' gradients of `roi_op` for g: K5 (K3 with one plane)
    through the operator's `register_autograd`."""
    leaves = [p.detach().requires_grad_() for p in args[0]]
    return torch.autograd.grad(roi_op((leaves, *args[1:])), leaves, g)


def plain_backward(g, args):
    """The plain backward one image at a time (the plain forward's matmuls
    transposed; its P2 intermediates are ~1 GB per image at N=256)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    per_image = [roi_mod.roi_align_multilevel_reference_backward(
        g[i:i + 1], [p[i:i + 1] for p in planes], rois[i:i + 1], levels[i:i + 1],
        valid[i:i + 1], ih[i:i + 1], iw[i:i + 1], crop, strides) for i in range(rois.shape[0])]
    return [torch.cat(ds) for ds in zip(*per_image)]


def axis_taps(lo, hi, dim, stride, crop, size):
    """Tap cells and weights [B, N, S, 2] of one axis, with the arithmetic of
    `taps` in csrc/roi_align_common.cuh (a tap past the plane weighs 0, its
    cell clamped to the plane), and the in-range samples [B, N, S]."""
    v, ok = roi_mod.level_sample_coords(lo, hi, dim, stride, crop)
    c0 = v.floor()
    cells = torch.stack([c0, c0 + 1.0], -1)
    w = torch.stack([(1.0 - (v - c0).abs()).clamp_min(0.0),
                     (1.0 - (v - (c0 + 1.0)).abs()).clamp_min(0.0)], -1)
    w = torch.where(cells < size, w, torch.zeros_like(w))
    return cells.long().clamp_max(size - 1), w * ok[..., None], ok


def backward_work(g, args):
    """What one backward call adds on these inputs: (terms, one per nonzero
    tap and channel; terms whose g is nonzero; vector reductions on the
    float4 path, else 0; scalar reductions on the scalar path, else 0). The
    reductions are a model of the kernel's walk, held against its counting
    build: along each sample row, the sum of w_x * g of each column the
    row's samples reach, unless every g unit in it is zero, goes to each of
    the row's taps of nonzero weight with one reduction."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    c = g.shape[-1]
    vec = vectorizable([], g)  # the wrapper's fresh gradient planes are aligned
    live_unit = g != 0  # [B, N, S, S, C]
    if vec:
        live_unit = live_unit.reshape(*g.shape[:-1], c // 4, 4).any(-1)
    channels = (g != 0).sum(-1)
    terms = live = reductions = 0
    for k, (plane, s) in enumerate(zip(planes, strides)):
        on = (levels == k) & valid
        ix, wx, x_ok = axis_taps(rois[..., 0], rois[..., 2], iw, s, crop, plane.shape[2])
        _, wy, y_ok = axis_taps(rois[..., 1], rois[..., 3], ih, s, crop, plane.shape[1])
        taps = ((wy[..., :, None, :, None] * wx[..., None, :, None, :]) != 0).sum((-1, -2))
        taps = taps * on[..., None, None]  # [B, N, S, S] nonzero taps of each sample
        terms += int(taps.sum()) * c
        live += int((taps * channels).sum())
        row_taps = ((wy != 0).sum(-1) * on[..., None]).unsqueeze(-1)  # [B, N, S, 1]
        # the walk, for all rois, rows and units at once
        a = torch.full(on.shape, -2, dtype=torch.long, device=g.device)
        live_a = torch.zeros_like(live_unit[..., 0, :])  # [B, N, S rows, units]
        live_b = torch.zeros_like(live_a)
        for j in range(crop):
            inside = x_ok[..., j] & on
            move = inside & (ix[..., j, 0] != a)
            step = (move & (ix[..., j, 0] == a + 1))[..., None, None]
            move = move[..., None, None]
            reductions += int(((live_a & move).sum(-1, keepdim=True) * row_taps).sum())
            reductions += int(((live_b & move & ~step).sum(-1, keepdim=True) * row_taps).sum())
            live_a = torch.where(step, live_b, live_a & ~move)
            live_b = live_b & ~move
            a = torch.where(move[..., 0, 0], ix[..., j, 0], a)
            reach = live_unit[..., :, j, :] & inside[..., None, None]
            live_a = live_a | (reach & (wx[..., j, 0] != 0)[..., None, None])
            live_b = live_b | (reach & (wx[..., j, 1] != 0)[..., None, None])
        reductions += int(((live_a.sum(-1, keepdim=True) + live_b.sum(-1, keepdim=True))
                           * row_taps).sum())
    return terms, live, reductions if vec else 0, 0 if vec else reductions


def backward_bound(g, args):
    """Bound of one backward call: g of the valid rois read once, every
    gradient plane written once in the planes' dtype (zeros plus the
    scatter), the small inputs; a multiply and an add per nonzero tap and
    nonzero channel of g. Also the work of `backward_work`."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    c = planes[0].shape[-1]
    work = backward_work(g, args)
    nbytes = int(valid.sum()) * crop * crop * c * 4 + sum(p.numel() * p.element_size()
                                                           for p in planes)
    nbytes += sum(t.numel() * t.element_size() for t in (rois, levels, valid, ih, iw))
    return (*bound(nbytes, work[1] * BWD_OPS_PER_TAP), *work)


def dense_grad(args):
    """An N(0, 1) output gradient for the fixture."""
    b, n = args[1].shape[:2]
    return torch.randn(b, n, CROP, CROP, args[0][0].shape[-1],
                       generator=torch.Generator().manual_seed(b * n)).cuda()


def pooled_grad(args):
    """The training path's output gradient: the 2x2 max pool's backward of an
    N(0, 1) gradient of the pooled crops (K4's output on the fixture), so
    three of every four samples of a channel are exactly zero."""
    crops = ROI_ALIGN_KERNEL(*args).requires_grad_()
    pooled = roi_mod.max_pool_2x2_same(crops)
    cot = torch.randn(pooled.shape, generator=torch.Generator().manual_seed(7)).cuda()
    (g,) = torch.autograd.grad(pooled, crops, cot)
    return g.contiguous()


def grid_sample_backward(g, args):
    """The autograd backward of `grid_sample` per level on the same sample
    points, as a near-equivalent reference only (it scatters every roi into
    every level, with single taps zeroed outside the plane). Returns a closure
    over a forward made outside the timing."""
    ins, outs = [], []
    for x, grid in level_grids(args):
        x.requires_grad_()
        ins.append(x)
        outs.append(F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                  align_corners=True))
    gs = [g.permute(0, 4, 1, 2, 3).reshape(o.shape).to(o.dtype).contiguous() for o in outs]
    return lambda: torch.autograd.grad(outs, ins, gs, retain_graph=True)


def check_backward(name, kernel, counting, g, args_list):
    """A backward kernel (one launch per element of `args_list`) against the
    plain backward: each cell within 1e-5 of sum |g * w| over its terms (the
    plain backward of |g|); the reductions its counting build issues against
    the model's. Returns the record."""
    err = rel = 0.0
    for args in args_list:
        got = kernel(g, [tuple(p.shape) for p in args[0]], *args[1:])
        torch.cuda.synchronize()
        ref = plain_backward(g, args)
        scale = plain_backward(g.abs(), args)
        for d, r, m in zip(got, ref, scale):
            diff = (d - r).abs()
            require(bool((diff <= 1e-5 * m).all()) and bool(torch.isfinite(d).all()),
                    f"{name} differs from the plain backward: max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / m.clamp_min(1e-30)).max()))
        for d, r, m in zip(roi_op_grads(g, args), ref, scale):
            require(bool(((d - r).abs() <= 1e-5 * m).all()),
                    f"{name} through the operator's autograd differs from the plain backward")
        del got, ref, scale
    ms = graph_ms(lambda: [kernel(g, [tuple(p.shape) for p in a[0]], *a[1:]) for a in args_list])
    plain_ms = cuda_ms(lambda: [plain_backward(g, a) for a in args_list], iters=2, warmup=1)
    bounds = [backward_bound(g, a) for a in args_list]
    model = {"vector": sum(b[4] for b in bounds), "scalar": sum(b[5] for b in bounds)}
    issued = counted_reductions(counting, g, args_list)
    require(issued == model, f"{name} issued {issued} reductions, its model {model}")
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=sum(b[0] for b in bounds), bound_by=bounds[0][1],
                terms=sum(b[2] for b in bounds), reductions=issued)


def check_forward(name, kernel, args_list):
    """A forward kernel (one launch per element of `args_list`, summed) against
    the plain version within atol/rtol 1e-5. Returns the record."""
    got = sum(kernel(*a) for a in args_list)
    torch.cuda.synchronize()
    ref = sum(plain_per_image(a) for a in args_list)
    err = float((got - ref).abs().max())
    require(float(((got - ref).abs() - 1e-5 * ref.abs()).max()) <= 1e-5
            and bool(torch.isfinite(got).all()), f"{name} differs from the plain version: "
            f"max abs err {err}")
    del got, ref
    ms = graph_ms(lambda: [kernel(*a) for a in args_list])
    plain_ms = cuda_ms(lambda: [plain_per_image(a) for a in args_list], iters=2, warmup=1)
    bounds = [roi_bound(a) for a in args_list]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=sum(b[0] for b in bounds),
                bound_by=bounds[0][1])


def check_training_kernels(card, counting):
    """K5 (fused backward), K3 (single-level backward, four launches: one per
    level) and K2 (single-level forward, four launches) against their plain
    versions at the stock training shape (B=1, N=256) with dense and with
    pool-sparse g, at B=4 and on an overlap-heavy and an edge / invalid /
    aspect-30 fixture. Returns {kernel: {case: record}}."""
    rng = np.random.RandomState(2)
    train = roi_fixture(rng, 1, TRAIN_ROIS, [[600, 800]], invalid=0.0)
    cases = [
        ("train_b1", train, dense_grad),
        ("train_b4", roi_fixture(rng, BATCH, TRAIN_ROIS,
                                 [[600, 800], [600, 1000], [576, 768], [640, 853]], invalid=0.0),
         dense_grad),
        ("overlap", roi_fixture(rng, 1, TRAIN_ROIS, [[600, 800]], invalid=0.0, overlap=True),
         dense_grad),
        ("edges_invalid_elongated", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]],
                                                invalid=0.3, special=True), dense_grad),
        ("train_b1_pool_sparse_g", train, pooled_grad),
        ("past_the_planes", roi_fixture(rng, 2, 64, PAST_THE_PLANES, invalid=0.3, special=True),
         dense_grad),
    ]
    record = {"roi_align_multilevel_backward": {}, "roi_align_single_level_backward": {},
              "roi_align_single_level": {}}
    for case, args, make_grad in cases:
        b, n = args[1].shape[:2]
        g = make_grad(args)
        k5 = check_backward("K5", ROI_ALIGN_BACKWARD_KERNEL, counting, g, [args])
        k5["near_reference_ms"] = cuda_ms(grid_sample_backward(g, args), iters=5)
        k3 = check_backward("K3", ROI_ALIGN_SINGLE_BACKWARD_KERNEL, counting, g,
                            per_level(args))
        k3["near_reference_ms"] = k5["near_reference_ms"]
        pairs = [("roi_align_multilevel_backward", k5), ("roi_align_single_level_backward", k3)]
        if make_grad is dense_grad:  # K2 does not read g
            k2 = check_forward("K2", ROI_ALIGN_SINGLE_KERNEL, per_level(args))
            k2["near_reference_ms"] = cuda_ms(grid_sample_levels(args), iters=10)
            pairs.append(("roi_align_single_level", k2))
        for kname, rec in pairs:
            record[kname][case] = rec
            extra = (f", max rel err {rec['max_rel_err']:.3g} of sum|g*w| (tolerance 1e-5), "
                     f"{rec['terms']} (tap, channel) terms, reductions issued (counted) "
                     f"{rec['reductions']}") if "terms" in rec else " (atol/rtol 1e-5)"
            print(f"{kname} {case} [B={b}, N={n}]: max_abs_err {rec['max_abs_err']:.3g}{extra}, "
                  f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), grid_sample per level "
                  f"(near-equivalent reference, not the same function) "
                  f"{rec['near_reference_ms']:.4f} ms  ({card})")
        del g
        torch.cuda.empty_cache()
    return record


# ------------------------------------------------------------- bf16 planes
SERVED_HWS = [[600, 800], [600, 1000], [576, 768], [640, 853]]


def bf16_planes(args):
    """The fixture with its planes rounded to bfloat16."""
    return ([p.bfloat16() for p in args[0]], *args[1:])


def widened(args):
    """The fixture with its planes widened to float32 (exactly)."""
    return ([p.float() for p in args[0]], *args[1:])


def check_bf16_forward(card):
    """K4 and K2 on bf16 planes (the bf16 variant of csrc/roi_align.cu):
    bit-equal to the same kernel on the planes widened to float32, on its
    16-byte path (8 channels a unit) and its scalar path (C = 42, and planes
    2 bytes off a 16-byte boundary); within atol/rtol 1e-5 of the plain
    version; graph-replay times beside the float32 variant's on the widened
    planes; bounds from the bf16 plane bytes. Returns {kernel: {case: record}}."""
    rng = np.random.RandomState(11)
    spec = dict(invalid=0.3, special=True)
    cases = [
        ("served", roi_fixture(rng, BATCH, 1000, SERVED_HWS)),
        ("train_b1", roi_fixture(rng, 1, TRAIN_ROIS, [[600, 800]], invalid=0.0)),
        ("edges_invalid_elongated", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]], **spec)),
        ("channels_42", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]], c=42, **spec)),
        ("misaligned_planes", misaligned(bf16_planes(
            roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]], **spec)))),
    ]
    record = {"roi_align_multilevel_bf16": {}, "roi_align_single_level_bf16": {}}
    for name, args in cases:
        a16 = bf16_planes(args)
        a32 = widened(a16)
        variants = [("roi_align_multilevel_bf16", ROI_ALIGN_KERNEL, [a16], [a32])]
        if name == "train_b1":  # K2: one launch per level, as the per-level training path
            variants.append(("roi_align_single_level_bf16", ROI_ALIGN_SINGLE_KERNEL,
                             per_level(a16), per_level(a32)))
        for kname, kernel, l16, l32 in variants:
            err = 0.0
            for x16, x32 in zip(l16, l32):
                got, want = kernel(*x16), kernel(*x32)
                path = "16-byte" if vectorizable(x16[0], got) else "scalar"
                require(torch.equal(roi_op(x16), got),
                        f"{kname} {name}: the operator differs from its kernel's wrapper")
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"{kname} {name}: bf16 planes differ from the "
                        f"float32 kernel on the widened planes")
                ref = plain_per_image(x16)
                err = max(err, float((got - ref).abs().max()))
                require(float(((got - ref).abs() - 1e-5 * ref.abs()).max()) <= 1e-5,
                        f"{kname} {name}: differs from the plain version by {err}")
                del got, want, ref
            ms = graph_ms(lambda: [kernel(*x) for x in l16])
            f32_ms = graph_ms(lambda: [kernel(*x) for x in l32])
            plain_ms = cuda_ms(lambda: [plain_per_image(x) for x in l16], iters=1, warmup=1)
            bounds = [roi_bound(x) for x in l16]
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=sum(b[0] for b in bounds), bound_by=bounds[0][1],
                       float32_planes_ms=f32_ms, path=path,
                       near_reference_ms=cuda_ms(grid_sample_levels(a16), iters=10))
            record[kname][name] = rec
            b, n = args[1].shape[:2]
            print(f"{kname} {name} [B={b}, N={n}, C={args[0][0].shape[-1]}, {path} path, "
                  f"{len(l16)} launch(es)]: bit-equal to the float32 kernel on the widened planes,"
                  f" max_abs_err {err:.3g} vs plain (atol/rtol 1e-5), kernel {ms:.4f} ms "
                  f"(float32 planes {f32_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), grid_sample x4 levels on the "
                  f"bf16 planes (near-equivalent reference, not the same function) "
                  f"{rec['near_reference_ms']:.4f} ms  ({card})")
        del a16, a32
        torch.cuda.empty_cache()
    return record


def check_backward_bf16(kernel, g, args_list):
    """A backward kernel for bf16 planes (one launch per element of
    `args_list`): the float32 accumulators within 1e-5 of sum |g * w| of the
    plain backward, the returned bf16 planes equal to them rounded. Returns
    the record, with the time of the whole call (zeroing, kernel, cast) and
    of the cast alone."""
    err = rel = 0.0
    accs = []
    for args in args_list:
        shapes = [tuple(p.shape) for p in args[0]]
        planes16, acc = kernel.accumulate(g, shapes, *args[1:], torch.bfloat16)
        torch.cuda.synchronize()
        require(all(d.dtype == torch.bfloat16 and torch.equal(d, a.bfloat16())
                    for d, a in zip(planes16, acc)),
                "bf16 gradient planes are not the rounded accumulators")
        ref = plain_backward(g, widened(args))
        scale = plain_backward(g.abs(), widened(args))
        for a, r, m in zip(acc, ref, scale):
            diff = (a - r).abs()
            require(bool((diff <= 1e-5 * m).all()) and bool(torch.isfinite(a).all()),
                    f"bf16 backward accumulators differ: max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / m.clamp_min(1e-30)).max()))
        accs.extend(acc)
        del planes16, ref, scale
    calls = [(tuple(tuple(p.shape) for p in a[0]), a[1:]) for a in args_list]
    ms = graph_ms(lambda: [kernel(g, list(sh), *rest, torch.bfloat16) for sh, rest in calls])
    f32_ms = graph_ms(lambda: [kernel(g, list(sh), *rest) for sh, rest in calls])
    cast_ms = graph_ms(lambda: [a.to(torch.bfloat16) for a in accs])
    plain_ms = cuda_ms(lambda: [plain_backward(g, a) for a in args_list], iters=1, warmup=1)
    bounds = [backward_bound(g, a) for a in args_list]
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=sum(b[0] for b in bounds), bound_by=bounds[0][1], cast_ms=cast_ms,
                float32_planes_ms=f32_ms)


def check_bf16_backward(card):
    """K5 (fused) and K3 (per level) for bf16 planes at the training shape
    (B=1, N=256) with N(0, 1) and pool-sparse g, and at B=4. Returns
    {kernel: {case: record}}."""
    rng = np.random.RandomState(12)
    train = bf16_planes(roi_fixture(rng, 1, TRAIN_ROIS, [[600, 800]], invalid=0.0))
    cases = [("train_b1", train, dense_grad), ("train_b1_pool_sparse_g", train, pooled_grad),
             ("train_b4", bf16_planes(roi_fixture(rng, BATCH, TRAIN_ROIS, SERVED_HWS,
                                                  invalid=0.0)), dense_grad)]
    record = {"roi_align_multilevel_backward_bf16": {},
              "roi_align_single_level_backward_bf16": {}}
    for case, args, make_grad in cases:
        g = make_grad(args)
        b, n = args[1].shape[:2]
        near_ms = cuda_ms(grid_sample_backward(g, args), iters=5)
        for kname, kernel, args_list in (
                ("roi_align_multilevel_backward_bf16", ROI_ALIGN_BACKWARD_KERNEL, [args]),
                ("roi_align_single_level_backward_bf16", ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
                 per_level(args))):
            rec = check_backward_bf16(kernel, g, args_list)
            rec["near_reference_ms"] = near_ms
            record[kname][case] = rec
            print(f"{kname} {case} [B={b}, N={n}]: bf16 planes = the float32 accumulators "
                  f"rounded; accumulators max_abs_err {rec['max_abs_err']:.3g}, max rel err "
                  f"{rec['max_rel_err']:.3g} of sum|g*w| (tolerance 1e-5); call (zeroing, kernel, "
                  f"cast) {rec['ms']:.4f} ms, of which the cast {rec['cast_ms']:.4f} ms (float32 "
                  f"planes {rec['float32_planes_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), grid_sample's autograd "
                  f"backward per level on the bf16 planes (near-equivalent reference) "
                  f"{near_ms:.4f} ms  ({card})")
        del g
        torch.cuda.empty_cache()
    return record


# ------------------------------------------------------------------ serving
def make_requests(seed: int = 0):
    """Raw uint8 RGB images: smooth gradients plus noise."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in REQUEST_SIZES:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
        out.append(np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


def serve(det, requests, cfg, image_format=None):
    """All requests arrive at t0; returns ({index: (Detections on host, raw hw)},
    {index: latency s}, total s, batches flushed). `image_format` as the
    eval command lines pass it (an FPN_Tensorflow import's "rgb")."""
    t0 = time.perf_counter()
    # (padded, hw, scale, raw_h, raw_w)
    items = (preprocess_eval_image(img, cfg, image_format=image_format) for img in requests)
    results, latency, per_bucket = {}, {}, {}
    for idx, item, raw in batched_im_detect(det, items, BATCH):
        bucket = item[0].shape[:2]
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
        results[idx] = post_process(raw, item, cfg, det.num_classes)
        latency[idx] = time.perf_counter() - t0
    batches = sum(-(-n // BATCH) for n in per_bucket.values())
    return results, latency, time.perf_counter() - t0, batches


def post_process(raw, item, cfg, num_classes):
    """One image's `im_detect` outputs (rois on raw-image coordinates) and
    its preprocessed item -> (Detections on the host, raw hw): the class-
    batched NMS (K1) of `post_ops_prediction`."""
    sm, deltas, rois, valid = raw
    raw_h, raw_w = item[3], item[4]
    dets = post_ops_prediction(
        sm, deltas, rois, valid, raw_h, raw_w,
        target_means=tuple(cfg["roi_proposal_means"]),
        target_stds=tuple(cfg["roi_proposal_stds"]),
        max_num_per_class=cfg["max_objects_per_class_per_image"],
        max_num_per_image=cfg["max_objects_per_image"],
        nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
        score_threshold=cfg["prediction_score_threshold"],
        min_edge=10.0,  # the VOC writer's min_size, on raw-image coordinates
        num_classes=num_classes,
    )
    return type(dets)(*(t.cpu() for t in dets)), (raw_h, raw_w)


def check_detections(results, n, slots, num_classes=21):
    require(sorted(results) == list(range(n)), f"results for {sorted(results)}")
    for idx, (d, (raw_h, raw_w)) in results.items():
        require(d.boxes.shape == (slots, 4) and d.scores.shape == (slots,),
                f"request {idx}: shape {tuple(d.boxes.shape)}")
        require(d.boxes.dtype == d.scores.dtype == torch.float32,
                f"request {idx}: dtypes {d.boxes.dtype}, {d.scores.dtype}")
        require(bool(torch.isfinite(d.boxes).all() and torch.isfinite(d.scores).all()),
                f"request {idx}: non-finite output")
        v = d.valid
        require(bool(v.any()), f"request {idx}: no detection")
        b = d.boxes[v]
        require(float(b.min()) >= 0.0 and float(b[:, 2].max()) <= raw_w - 1
                and float(b[:, 3].max()) <= raw_h - 1, f"request {idx}: box outside the image")
        require(bool(((d.labels[v] >= 1) & (d.labels[v] < num_classes)).all()),
                f"request {idx}: label")
        s = d.scores[v]
        require(bool((s > 0).all() and (s[:-1] >= s[1:]).all()), f"request {idx}: score order")


# model type -> (small-input overrides, image size, image_hw, rpn / roi score-layer scales)
CPU_CHECKS = {
    "faster_rcnn": (dict(rpn_proposal_test_pre_nms_sample_number=300,
                         rpn_proposal_test_after_nms_sample_number=50), 160, [144, 128], 5.0, 10.0),
    "fpn": (dict(rpn_proposal_test_pre_nms_sample_number=512,
                 rpn_proposal_test_after_nms_sample_number=64), 128, [120, 124], 20.0, 10.0),
}


# N(0, 1) pixels times this: VGG16's 13 ReLU layers at lecun init shrink a
# unit input ~90x, so its random-weight RPN scores would tie near 0.5 on
# unit pixels; caffe-scaled ones (N(0, 50)) separate them
PIXEL_SCALE = {"vgg16": 50.0}


def describe(model_type, backbone="resnet50", cfg=None) -> str:
    """A path's model: `faster_rcnn`, `faster_rcnn vgg16`, `fpn slim`,
    `faster_rcnn coco` (the COCO config's 81 classes), ..."""
    parts = [model_type] + ([backbone] if backbone != "resnet50" else [])
    if cfg is not None and cfg.get("tpu_fpn_backbone_style", "keras") != "keras":
        parts.append(cfg["tpu_fpn_backbone_style"])
    if cfg is not None and cfg["num_classes"] == 81:
        parts.append("coco")
    return " ".join(parts)


def check_against_cpu(model_type, cfg, card, backbone="resnet50", calibrate=False,
                      imported=None, name=None):
    """predict on the card against the port's CPU path (plain NMS and
    RoIAlign, held against JAX by tests/test_torch_model.py and
    tests/test_torch_fpn.py) on a small input, same seeded weights.

    As in those tests, the score layers are scaled so that random-weight
    scores separate (a tie may legitimately pick other proposals). Labels
    and validity exact; scores atol 1e-4; boxes atol 1e-3 px (an RPN delta
    that differs by ~1e-6 from summation order times anchor extents up to
    512 px). With `imported` (a state_dict: a synthetic checkpoint's
    import), both detectors take those weights as they are, on pixels of
    the caffe range (N(0, 64)).
    """
    overrides, size, hw, rpn_scale, roi_scale = CPU_CHECKS[model_type]
    small = dict(cfg, max_objects_per_image=10, max_objects_per_class_per_image=10, **overrides)
    pixel_scale = 64.0 if imported is not None else PIXEL_SCALE.get(backbone, 1.0)
    image = (np.random.RandomState(1).randn(size, size, 3) * pixel_scale).astype(np.float32)
    state = calibrated_state(model_type, backbone, small, image[None]) if calibrate else imported
    out = []
    for device in ("cuda", "cpu"):
        det = model_factory(model_type, backbone, small, device=device, seed=1)
        if state is not None:
            det.load_state_dict(state)
        if imported is None:
            with torch.no_grad():
                det.rpn_head.rpn_score_conv.weight.mul_(rpn_scale)
                det.roi_head.roi_head_score.weight.mul_(roi_scale)
        out.append([t.cpu() for t in det.predict(image, hw)])
    (gb, gl, gs, gv), (cb, cl, cs, cv) = out
    name = name or describe(model_type, backbone, cfg)
    require(imported is None or bool(cv.any()), f"{name}: no detection on the cpu")
    require(torch.equal(gv, cv) and torch.equal(gl, cl),
            f"{name} cuda vs cpu: labels or validity differ")
    box_err = float((gb - cb).abs().max())
    score_err = float((gs - cs).abs().max())
    require(box_err <= 1e-3 and score_err <= 1e-4,
            f"{name} cuda vs cpu: box err {box_err}, score err {score_err}")
    print(f"{name} predict {size}x{size}, cuda vs the port's cpu path: {int(gv.sum())} "
          f"detections, labels and validity equal, box err {box_err:.3g} px, score err "
          f"{score_err:.3g}  ({card})")


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def stage_breakdown(det, images, hw, card):
    """Host-clock time of each stage of one batch, synchronised between
    stages; returns {stage: ms}."""
    with torch.inference_mode():
        if det.model_type == "fpn":
            (p_list, score, bbox), t_bb = timed(lambda: det._backbone_neck_rpn(images))
            (rois, valid), t_rp = timed(
                lambda: det._proposals(*det._flatten_levels(score, bbox), hw))
            feats, t_crop = timed(lambda: det._roi_features(p_list, rois, valid, hw))
            _, t_head = timed(lambda: det._roi_head(feats))
            names = ("backbone+neck+rpn", "proposals (incl. NMS)", "K4 roi align + pool", "roi head")
        else:
            (feats, score, bbox), t_bb = timed(lambda: det._backbone_rpn(images))
            (rois, valid), t_rp = timed(lambda: det._proposals(score, bbox, hw))
            crops, t_crop = timed(lambda: roi_mod.roi_crop_faster_rcnn(
                feats, rois, det.stride, det.cfg["roi_pooling_size"], det.roi_max_pooling))
            _, t_head = timed(lambda: det.roi_head(crops.reshape(-1, *crops.shape[2:])))
            names = ("backbone+rpn", "proposals (incl. NMS)", "roi crop", "roi head")
    times = (t_bb, t_rp, t_crop, t_head)
    print(f"{describe(det.model_type, det.backbone_name, det.cfg)} {dtype_name(det)} stages, "
          f"batch {images.shape[0]} at "
          f"{tuple(images.shape[1:3])}: "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in zip(names, times)) + f"  ({card})")
    return dict(zip(names, times))


def dtype_name(det) -> str:
    return str(det.compute_dtype).removeprefix("torch.")


def peak_flop_per_s(det) -> float:
    """The card's peak for the detector's compute dtype (convolutions and
    dense layers)."""
    return BF16_FLOP_PER_S if det.compute_dtype == torch.bfloat16 else F32_FLOP_PER_S


def layer_flops(det, fn, backward=False) -> int:
    """FLOPs (2 per multiply-add) of the Conv2d and Linear layers in one call of
    `fn`; with `backward`, those of its backward too: a layer's forward work
    again for its weight's gradient if the weight trains, and again for its
    input's gradient if the input carries one."""
    total = 0

    def count(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            work = 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            work = 2 * out.numel() * mod.in_features
        if backward:
            work *= 1 + mod.weight.requires_grad + inputs[0].requires_grad
        total += work

    handles = [m.register_forward_hook(count) for m in det.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total


def device_profile(fn, card, top: int = 8):
    """One profiled call of `fn`: device busy time (sum of kernel self times;
    one stream, so kernels do not overlap) against the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"profile: no device time recorded; idle share not measured  ({card})")
        return None
    print(f"profile, one call: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}  ({card})")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    ours = [(re.search(r"(nms_\w+_kernel|roi_align_ml_\w*kernel)", e.key), e) for e in kernels]
    print("  port kernels: " + ", ".join(
        f"{m.group(0)} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for m, e in ours if m))
    return 1 - busy_ms / wall_ms


class NmsShapes:
    """While active, records ([B, K] -> max_output) of every K1 launch that
    goes through the NMS operator (the launch counts stay the kernel's own)."""

    def __enter__(self):
        self.shapes, self._kernel = [], op_lib.NMS_KERNEL

        def record(boxes, valid, iou_threshold, max_output):
            self.shapes.append((*boxes.shape[:2], max_output))
            return self._kernel(boxes, valid, iou_threshold, max_output)

        op_lib.NMS_KERNEL = record
        return self

    def __exit__(self, *exc):
        op_lib.NMS_KERNEL = self._kernel

    def check(self, path, expected: dict):
        """The launches by shape (B, K, max_output) must be `expected`."""
        got = {}
        for shape in self.shapes:
            got[shape] = got.get(shape, 0) + 1
        print(f"{path} K1 launches by [B, K] -> max_output: "
              + ", ".join(f"[{b},{k}]->{m} x{n}" for (b, k, m), n in sorted(got.items())))
        require(got == expected, f"{path} K1 shapes {got} != expected {expected}")


def served_nms_shapes(cfg, batches, images, predicts=0):
    """K1's shapes on a serving path: the RPN NMS of each batch of BATCH and
    of each `predict`, the class-batched NMS of each image and `predict`."""
    pre, post = (cfg["rpn_proposal_test_pre_nms_sample_number"],
                 cfg["rpn_proposal_test_after_nms_sample_number"])
    per_class = (cfg["num_classes"] - 1, post, cfg["max_objects_per_class_per_image"])
    out = {(BATCH, pre, post): batches, per_class: images + predicts}
    if predicts:
        out[(1, pre, post)] = predicts
    return out


def drive_path(model_type, requests, card, dtype="float32", f32=None, backbone="resnet50",
               path=None, data_type="pascal"):
    """One model's serving path in `dtype` compute with the `data_type`
    config; returns (the kernel launches of its run, its figures). Under
    bfloat16 compute the backbone's output is held against the float32
    detector of the same seed and the figures print beside `f32`'s, the
    float32 path's. K1's launches are checked by shape too."""
    cfg = dict(config_factory(data_type, model_type), tpu_compute_dtype=dtype)
    bf16 = dtype == "bfloat16"
    if not bf16:
        check_against_cpu(model_type, cfg, card, backbone)
    det = model_factory(model_type, backbone, cfg, device="cuda", seed=0)
    serve(det, requests, cfg)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    reset_launches()
    with NmsShapes() as shapes:
        results, latency, total, batches = serve(det, requests, cfg)
        padded, hw, *_ = preprocess_eval_image(requests[0], cfg)
        one = det.predict(padded, hw)
        one = type(one)(*(t.cpu() for t in one))
    launches = launch_counts()

    slots = cfg["max_objects_per_image"]
    check_detections(results, len(requests), slots, det.num_classes)
    check_detections({0: (one, (int(hw[0]), int(hw[1])))}, 1, slots, det.num_classes)
    # one batched RPN NMS per flushed batch, one class-batched NMS per image;
    # FPN: one K4 launch per flushed batch and one for predict, on planes of
    # the compute dtype
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = batches + len(requests) + 2
    k4 = "roi_align_multilevel_bf16" if bf16 else "roi_align_multilevel"
    expected[k4] = batches + 1 if model_type == "fpn" else 0
    path = path or (f"{model_type}_bf16" if bf16 else model_type)
    print(f"{path} kernel launches in the main path: {launches} (expected {expected}: "
          f"{batches} batches, {len(requests)} per-class NMS, predict)")
    require(launches == expected, f"{path} launches {launches} != expected {expected}")
    shapes.check(path, served_nms_shapes(cfg, batches, len(requests), predicts=1))

    lat = np.sort(np.asarray(list(latency.values()))) * 1e3
    print(f"{path} serving {len(requests)} requests, batch {BATCH}, incl. host "
          f"preprocessing: {len(requests) / total:.3f} images/s, per-request latency p50 "
          f"{np.percentile(lat, 50):.1f} ms max {lat[-1]:.1f} ms  ({card})")

    # device-side throughput on preprocessed landscape inputs
    pre = [preprocess_eval_image(img, cfg) for img in requests]
    bucket_h = min(b[0] for b in cfg["tpu_image_buckets"])
    land = [p for p in pre if p[0].shape[0] == bucket_h][:BATCH]
    images = torch.as_tensor(np.stack([p[0] for p in land]), device=det.device)
    hws = torch.as_tensor(np.stack([p[1] for p in land]), device=det.device).long()
    scales = torch.ones(BATCH, device=det.device)
    torch.cuda.reset_peak_memory_stats()
    batch_ms = cuda_ms(lambda: det.im_detect_batch(images, hws, scales), iters=5)
    predict_ms = cuda_ms(lambda: det.predict(images[0], hws[0]), iters=5)
    size = "x".join(map(str, images.shape[1:3]))
    print(f"{path} im_detect_batch b{BATCH} {size}: {batch_ms:.2f} ms/batch = "
          f"{BATCH * 1e3 / batch_ms:.3f} images/s; predict b1: {predict_ms:.2f} ms  ({card})")
    tflop = layer_flops(det, lambda: det.im_detect_batch(images, hws, scales)) / 1e12
    print(f"{path} conv + linear work {tflop:.4f} TFLOP per batch: "
          f"{tflop / batch_ms * 1e3:.2f} TFLOP/s over the whole call, "
          f"{tflop / batch_ms * 1e3 / (peak_flop_per_s(det) / 1e12):.3f} of the {dtype} peak"
          f"  ({card})")
    stages = stage_breakdown(det, images, hws, card)
    idle = device_profile(lambda: det.im_detect_batch(images, hws, scales), card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{path} peak device memory {peak:.2f} GiB  ({card})")
    figures = dict(batch_ms=batch_ms, predict_ms=predict_ms, stages=stages, idle=idle, peak=peak)
    if bf16:
        compare_backbone(det, dict(cfg, tpu_compute_dtype="float32"), images, card)
        print(f"{path} against {describe(model_type, backbone)} float32 (this run): "
              f"im_detect_batch "
              f"{batch_ms:.2f} vs {f32['batch_ms']:.2f} ms ({f32['batch_ms'] / batch_ms:.2f}x), "
              f"predict {predict_ms:.2f} vs {f32['predict_ms']:.2f} ms, peak "
              f"{peak:.2f} vs {f32['peak']:.2f} GiB; stages " + ", ".join(
                  f"{k} {v:.2f} vs {f32['stages'][k]:.2f} ms" for k, v in stages.items())
              + f"  ({card})")
    del det
    torch.cuda.empty_cache()
    return launches, figures


def compare_backbone(det, cfg32, images, card):
    """The bf16 detector's backbone output (C4 or VGG16 features; FPN p2..p6)
    against the float32 detector of the same seed on the same batch:
    rel = |bf16 - f32| / (|f32| + 1), rel.mean() < 0.05 (tests/test_bf16.py)."""
    det32 = model_factory(det.model_type, det.backbone_name, cfg32, device="cuda", seed=0)
    with torch.inference_mode():
        if det.model_type == "fpn":
            got, want = det._backbone_neck_rpn(images)[0], det32._backbone_neck_rpn(images)[0]
        else:
            got, want = [det._backbone_rpn(images)[0]], [det32._backbone_rpn(images)[0]]
    rels = []
    for a, b in zip(got, want):
        require(a.dtype == torch.bfloat16 and b.dtype == torch.float32,
                f"backbone dtypes {a.dtype}, {b.dtype}")
        rels.append(float(((a.float() - b).abs() / (b.abs() + 1.0)).mean()))
    name = describe(det.model_type, det.backbone_name)
    require(max(rels) < 0.05, f"{name} bf16 backbone vs float32: rel.mean() {rels}")
    print(f"{name} bf16 backbone output vs float32 on the same weights and batch: "
          f"rel.mean() {', '.join(f'{r:.4f}' for r in rels)} (bound 0.05)  ({card})")
    del det32


# ----------------------------------------------------------------- training
# small-input overrides of the card-vs-CPU training step (as
# tests/test_torch_fpn_train.py and tests/test_torch_faster_rcnn_train.py;
# Faster R-CNN takes anchor scales (2, 4, 8) so that its anchors fit a
# 128x128 image) and the RPN score-layer scale that separates random-weight
# proposals at the pre-NMS cut
TRAIN_CPU_CHECK = {
    "fpn": dict(rpn_proposal_train_pre_nms_sample_number=512),
    "faster_rcnn": dict(rpn_proposal_train_pre_nms_sample_number=256, scales=[2, 4, 8]),
}
# the COCO config's four anchor scales at the 128x128 check: 12 anchors a
# cell of 16-128 px (the stock 64-512 px would hardly fit the image)
COCO_CPU_SCALES = [1, 2, 4, 8]
# the seed of the COCO card-vs-CPU training check's weights. A comparison of
# gradients needs a network with no unit near a ReLU kink: at seed 1 (the
# Pascal and FPN checks') the COCO network's conv4 gradients move by up to
# 1.9e-2 of their largest value on the CPU alone when the input is scaled
# by 1 + 1e-6 (the Pascal one's by 5.2e-3), more than GRAD_TOL, and the card
# differed by 3.1e-3; at seed 2 by at most 6e-4
COCO_CPU_SEED = 2
# the seeds of the other card-vs-CPU training checks' weights. Each check
# measures its own conditioning (`conditioning`: the CPU step at the input
# times 1 + INPUT_MOVE) and refuses a point where the CPU alone moves a
# gradient by more than the tolerance. Moves measured on a development
# CPU, largest over the gradients relative to each tensor's largest value:
# Pascal C4 seed 1 5.2e-3, seed 2 8.1e-4, seed 3 7.2e-4, seed 4 2.3e-4,
# seed 5 1.0e-3; FPN seed 1 2.9e-3, seed 2 1.6e-6, seed 3 2.0e-6; VGG16 seed
# 1 9.2e-4; COCO seed 2 8.1e-5. Seed 1 of Pascal C4 and of FPN moves by more
# than GRAD_TOL, so those two checks take seeds 4 and 2.
CPU_CHECK_SEED = {"faster_rcnn": 4, "fpn": 2, "vgg16": 1}
INPUT_MOVE = 1e-6
TRAIN_CPU_COMMON = dict(rpn_proposal_train_after_nms_sample_number=64, rpn_total_sample_number=64,
                        rpn_pos_sample_max_number=32, roi_total_sample_number=32,
                        roi_pos_sample_max_number=8, tpu_max_gt_boxes=8)
# per training step: the RPN NMS, then for FPN K4 + K5 fused or K2 + K3 once
# per level (Faster R-CNN crops with two matmuls: no RoIAlign kernel); under
# bf16 compute the RoIAlign kernels' bf16-plane variants
PER_STEP = {
    "fpn": {"nms_alive_sorted": 1, "roi_align_multilevel": 1,
            "roi_align_multilevel_backward": 1},
    "fpn_per_level": {"nms_alive_sorted": 1, "roi_align_single_level": 4,
                      "roi_align_single_level_backward": 4},
    "faster_rcnn": {"nms_alive_sorted": 1},
    "fpn_bf16": {"nms_alive_sorted": 1, "roi_align_multilevel_bf16": 1,
                 "roi_align_multilevel_backward_bf16": 1},
    "fpn_per_level_bf16": {"nms_alive_sorted": 1, "roi_align_single_level_bf16": 4,
                           "roi_align_single_level_backward_bf16": 4},
    "faster_rcnn_bf16": {"nms_alive_sorted": 1},
}
# steps of each bf16 training path (B=1, B=4, FPN per level), and of each
# VGG16 training path, float32 and bf16
BF16_STEPS = (6, 3, 2)
VGG16_STEPS = (5, 3, 0)
COCO_STEPS = (6, 3, 0)
PATH_NAME = {"fpn": "fpn", "faster_rcnn": "frcnn"}


# Card step vs the port's CPU step: every gradient within GRAD_TOL of its
# tensor's largest value (the tolerance of the CPU training tests) with
# cuDNN off, where the convolutions are PyTorch's own CUDA GEMMs; within
# CUDNN_GRAD_TOL with cuDNN on, whose FFT and Winograd convolutions round
# differently in float32 and move a few conv4 gradients of this random-weight
# network by more than GRAD_TOL (the check prints both worst cases).
GRAD_TOL = 2e-3
CUDNN_GRAD_TOL = 2e-2


def grads_close(got, want, tol) -> tuple[float, str]:
    """(largest |got - want| / max|want| over the tensors, its tensor);
    raises above `tol`."""
    worst = (0.0, "")
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        require(err <= tol, f"gradient of {name} differs by {err:.3g} of its largest value "
                f"(tolerance {tol})")
        worst = max(worst, (err, name))
    return worst


def calibrated_state(model_type, backbone, cfg, images):
    """The state of the seeded detector on the CPU with its frozen
    BatchNorms set to the statistics of `images` (numpy NHWC), for both
    sides of a card-vs-CPU check: identical weights on the two devices."""
    det = model_factory(model_type, backbone, cfg, device="cpu", seed=1)
    calibrate_frozen_bn(det, lambda: det.extractor(torch.as_tensor(images)))
    return det.state_dict()


def small_training_step(model_type, small, device, draws, inputs, pinned=None,
                        backbone="resnet50", state=None, seed=1):
    """One loss and backward of a detector of seed `seed` on the small input
    -> (metrics, gradients of the trainable tensors on the host). With
    `pinned` (a dict), the detector's training proposals go into it, or come
    from it when it holds them already; `state` replaces its weights."""
    det = model_factory(model_type, backbone, small, device=device, seed=seed)
    if state is not None:
        det.load_state_dict(state)
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
    if pinned is not None:
        own = det._proposals

        def proposals(*args, **kwargs):
            if "rois" not in pinned:
                pinned["rois"] = tuple(t.cpu() for t in own(*args, **kwargs))
            return tuple(t.to(device) for t in pinned["rois"])

        det._proposals = proposals
    total, metrics = det.loss_fn(*inputs, draws.to(device))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in det.named_parameters() if p.requires_grad})


def bf16_small_step_against_cpu(model_type, small, draws, inputs, card, backbone="resnet50"):
    """The bf16 loss and backward on the card against the port's CPU bf16
    path, with the CPU step's training proposals given to both (bf16 noise
    in the RPN deltas may flip a proposal across the RoI IoU threshold, as
    between the port and JAX, tests/test_torch_bf16.py): losses rtol 2e-2,
    counts equal, every gradient's cosine with the CPU's > 0.9 and all of
    them together > 0.99, the bounds of tests/test_torch_bf16.py."""
    pinned = {}
    name = describe(model_type, backbone, small)
    cm, cg = small_training_step(model_type, small, "cpu", draws, inputs, pinned, backbone)
    gm, gg = small_training_step(model_type, small, "cuda", draws, inputs, pinned, backbone)
    for k in cm:
        ktol = 2e-2 * abs(cm[k]) if k.endswith("loss") else 0.0
        require(abs(gm[k] - cm[k]) <= ktol, f"{name} bf16 training {k}: cuda {gm[k]} vs "
                f"cpu {cm[k]}")
    worst, overall = cosines(gg, cg, 0.9, 0.99, f"{name} bf16")
    print(f"{name} bf16 training loss + backward 128x128, cuda vs the port's cpu bf16 "
          f"path (the cpu step's proposals pinned): losses within rtol 2e-2 (total "
          f"{gm['total_loss']:.6f} vs {cm['total_loss']:.6f}), counts equal, gradient cosine "
          f">= {worst[0]:.4f} ({worst[1]}), overall {overall:.5f}  ({card})")


def cosines(got, want, each, together, name):
    """(the lowest cosine of a gradient in `got` with its tensor in `want`
    and that tensor's name, the cosine of all of them together); raises
    below `each` or `together`. A tensor that is zero must be zero on both."""
    worst, every = (2.0, ""), []
    for tensor, w in want.items():
        a, b = got[tensor].double().flatten(), w.double().flatten()
        if not a.any() or not b.any():
            require(not a.any() and not b.any(), f"{name} gradient of {tensor}")
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        require(cos > each, f"{name} gradient of {tensor}: cosine {cos}")
        worst = min(worst, (cos, tensor))
        every.append((a, b))
    a, b = torch.cat([x for x, _ in every]), torch.cat([y for _, y in every])
    overall = float(a @ b / (a.norm() * b.norm()))
    require(overall > together, f"{name} gradients: overall cosine {overall}")
    return worst, overall


def check_training_against_cpu(model_type, cfg, card, backbone="resnet50"):
    """One training loss and backward on the card against the port's CPU path
    (held against JAX by the CPU training tests) on a 128x128 input, same
    seeded weights and the same draws: losses rtol 1e-4, counts exact, every
    gradient within GRAD_TOL (cuDNN off) or CUDNN_GRAD_TOL (cuDNN on) of its
    tensor's largest value. A RoI gradient that failed to reach the
    backbone would show in its gradients at O(1). The RPN score layer is
    scaled so that random-weight proposals separate, as in the CPU tests.
    VGG16's draws carry the dropout masks, the same on both sides. The
    float32 check refuses an ill-conditioned point (`conditioning`) and
    prints the CPU's own move beside the gap."""
    small = dict(cfg, tpu_image_buckets=[[128, 128]], image_min_size=128, image_max_size=128,
                 **TRAIN_CPU_COMMON, **TRAIN_CPU_CHECK[model_type])
    seed = CPU_CHECK_SEED["vgg16" if backbone == "vgg16" else model_type]
    if cfg["num_classes"] == 81:
        small["scales"], seed = COCO_CPU_SCALES, COCO_CPU_SEED
    inputs = small_train_inputs(PIXEL_SCALE.get(backbone, 1.0))
    if model_type == "fpn":
        anchors = 3 * sum((-(-128 // s)) ** 2 for s in small["anchor_stride_list"])
    else:
        anchors = (128 // small["extractor_stride"]) ** 2 * 3 * len(small["scales"])
    dropout = (1.0 - (1.0 - cfg["roi_head_keep_dropout_rate"]), VGG16_HIDDEN) \
        if backbone == "vgg16" else None
    draws = TrainDraws.sample(torch.Generator().manual_seed(5), 1, anchors, 64, 32, dropout)
    if small["tpu_compute_dtype"] == "bfloat16":
        bf16_small_step_against_cpu(model_type, small, draws, inputs, card, backbone)
        return
    path = describe(model_type, backbone, cfg)
    cm, cg = small_training_step(model_type, small, "cpu", draws, inputs, backbone=backbone,
                                 seed=seed)
    require(cm["num_rpn_fg"] > 0, f"{path} small step without an RPN foreground: {cm}")
    cpu_move = conditioning(path, cg, lambda moved: small_training_step(
        model_type, small, "cpu", draws, moved, backbone=backbone, seed=seed)[1], inputs)
    for cudnn, tol in ((False, GRAD_TOL), (True, CUDNN_GRAD_TOL)):
        torch.backends.cudnn.enabled = cudnn
        try:
            gm, gg = small_training_step(model_type, small, "cuda", draws, inputs,
                                         backbone=backbone, seed=seed)
        finally:
            torch.backends.cudnn.enabled = True
        for k in cm:
            ktol = 1e-4 * abs(cm[k]) if k.endswith("loss") else 0.0
            require(abs(gm[k] - cm[k]) <= ktol,
                    f"{path} training {k}: cuda {gm[k]} vs cpu {cm[k]}")
        worst, name = grads_close(gg, cg, tol)
        print(f"{path} training loss + backward 128x128 (seed {seed}), cuda (cuDNN "
              f"{'on' if cudnn else 'off'}) vs the port's cpu path: losses within rtol 1e-4 "
              f"(total {gm['total_loss']:.6f} vs {cm['total_loss']:.6f}), counts equal, "
              f"{len(cg)} gradients within {worst:.3g} of their largest value ({name}; "
              f"tolerance {tol}); the cpu alone at input x (1 + {INPUT_MOVE:g}) moves them "
              f"by {cpu_move[0]:.3g} ({cpu_move[1]})  ({card})")


def conditioning(path, grads, step_at, inputs, tol=GRAD_TOL):
    """How far the CPU's gradients move, each relative to its tensor's
    largest value, when the input is scaled by 1 + INPUT_MOVE: `step_at`
    (inputs) -> the gradients there. Raises where the CPU alone moves by
    more than `tol`: at such a point (a unit on a ReLU kink) a card-vs-CPU
    gap within `tol` cannot be told from float order. -> (move, tensor)."""
    moved = (inputs[0] * np.float32(1.0 + INPUT_MOVE), *inputs[1:])
    worst = (0.0, "")
    for name, g in step_at(moved).items():
        move = float((g - grads[name]).abs().max()) / max(float(grads[name].abs().max()), 1e-30)
        worst = max(worst, (move, name))
    require(worst[0] <= tol, f"{path}: ill-conditioned point: the input x (1 + {INPUT_MOVE:g}) "
            f"moves the cpu's gradient of {worst[1]} by {worst[0]:.3g} of its largest value, "
            f"more than the tolerance {tol}; a card-vs-cpu comparison there says nothing")
    return worst


def slim_step_against_cpu(cfg, card):
    """One slim FPN training loss and backward on the card (cuDNN on)
    against the port's CPU path at 128x128, both from the CPU's calibrated
    state (`calibrated_state`) and the CPU step's proposals. With its frozen
    BatchNorms set to the batch's statistics the random slim network's
    gradients are ill-conditioned at this size: on the CPU, a 1e-6 relative
    change of its BatchNorm variances moves a conv4 gradient by 25% of its
    largest value (ReLU inputs of standardized activations sit within
    rounding of 0), while every gradient's cosine with the unchanged one
    stays >= 0.9993. So: losses rtol 1e-4, counts equal, every gradient's
    cosine with the CPU's > 0.99 and all of them together > 0.999."""
    small = dict(cfg, tpu_image_buckets=[[128, 128]], image_min_size=128, image_max_size=128,
                 **TRAIN_CPU_COMMON, **TRAIN_CPU_CHECK["fpn"])
    inputs = small_train_inputs(1.0)
    anchors = 3 * sum((-(-128 // s)) ** 2 for s in small["anchor_stride_list"])
    draws = TrainDraws.sample(torch.Generator().manual_seed(5), 1, anchors, 64, 32)
    state = calibrated_state("fpn", "resnet50", small, inputs[0])
    pinned = {}
    cm, cg = small_training_step("fpn", small, "cpu", draws, inputs, pinned, state=state)
    gm, gg = small_training_step("fpn", small, "cuda", draws, inputs, pinned, state=state)
    require(cm["num_rpn_fg"] > 0 and cm["num_roi_fg"] > 0, f"fpn slim small step counts {cm}")
    for k in cm:
        ktol = 1e-4 * abs(cm[k]) if k.endswith("loss") else 0.0
        require(abs(gm[k] - cm[k]) <= ktol, f"fpn slim training {k}: cuda {gm[k]} vs cpu {cm[k]}")
    worst, overall = cosines(gg, cg, 0.99, 0.999, "fpn slim")
    print(f"fpn slim training loss + backward 128x128, cuda vs the port's cpu path (calibrated "
          f"state and the cpu step's proposals on both): losses within rtol 1e-4 (total "
          f"{gm['total_loss']:.6f} vs {cm['total_loss']:.6f}), counts equal, gradient cosine "
          f">= {worst[0]:.6f} ({worst[1]}), overall {overall:.7f}  ({card})")


def small_train_inputs(pixel_scale):
    """The one-image 128x128 training batch of the card-vs-CPU checks."""
    rng = np.random.RandomState(3)
    image = (rng.randn(1, 128, 128, 3) * pixel_scale).astype(np.float32)
    hw = np.asarray([[120, 124]], np.int32)
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    gt_mask = np.arange(8)[None] < 3
    gt_labels = np.asarray([[3, 7, 12, 0, 0, 0, 0, 0]], np.int32)
    return image, hw, gt, gt_mask, gt_labels


def make_train_items(seed: int = 0, num_classes: int = 21):
    """The 8 request images with 1-8 random gt boxes each: (raw RGB, boxes
    [n, 4] normalized yxyx, labels [n] in 1..num_classes - 1)."""
    rng = np.random.RandomState(seed + 1)
    items = []
    for img in make_requests(seed):
        n = rng.randint(1, 9)
        lo = rng.uniform(0.0, 0.7, (n, 2))
        hi = np.minimum(lo + rng.uniform(0.08, 0.6, (n, 2)), 1.0)
        boxes = np.concatenate([lo, hi], 1).astype(np.float32)
        items.append((img, boxes, rng.randint(1, num_classes, n).astype(np.int32)))
    return items


def train_batch(items, cfg, rng):
    """`preprocess_train_image` (random flip) on each item, stacked on the card."""
    pre = [preprocess_train_image(img, boxes, labels, cfg, rng) for img, boxes, labels in items]
    return tuple(torch.as_tensor(np.stack(x), device="cuda") for x in zip(*pre))


def train_path(name, step, batches, gen, cfg, per_step, card):
    """Steps over `batches` with the launch counts set to 0 before and read
    after; checks losses, sample counts and launches. Returns the counts and
    the median step time after the first (ms)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    metrics = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    for i, m in enumerate(metrics):
        require(all(np.isfinite(v) for v in m.values()), f"{name} step {i}: non-finite {m}")
        require(m["num_rpn_fg"] + m["num_rpn_bg"] == cfg["rpn_total_sample_number"]
                and 0 < m["num_rpn_fg"] <= cfg["rpn_pos_sample_max_number"]
                and 0 <= m["num_roi_fg"] <= cfg["roi_pos_sample_max_number"]
                and 0 < m["num_proposals"] <= cfg["rpn_proposal_train_after_nms_sample_number"],
                f"{name} step {i}: sample counts {m}")
    expected = {k: per_step.get(k, 0) * len(batches) for k in KERNELS}
    print(f"{name}: kernel launches {launches} (expected {expected}: {len(batches)} steps)")
    require(launches == expected, f"{name} launches {launches} != expected {expected}")
    b = batches[0][0].shape[0]
    med = float(np.median(times[1:])) if len(times) > 1 else times[0]
    last = metrics[-1]
    print(f"{name}: {len(batches)} steps of batch {b}, step ms {[round(t, 2) for t in times]}, "
          f"median after the first {med:.2f} ms = {b * 1e3 / med:.3f} images/s; last step "
          f"losses rpn_cls {last['rpn_cls_loss']:.4f} rpn_reg {last['rpn_reg_loss']:.4f} "
          f"roi_cls {last['roi_cls_loss']:.4f} roi_reg {last['roi_reg_loss']:.4f}, samples "
          f"rpn fg/bg {last['num_rpn_fg']:.0f}/{last['num_rpn_bg']:.0f} (of "
          f"{cfg['rpn_total_sample_number']}), roi fg {last['num_roi_fg']:.0f} (of "
          f"{cfg['roi_total_sample_number']} sampled), proposals {last['num_proposals']:.0f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({card})")
    return launches, med


def train_stages(det, opt, batch, gen, card):
    """Host-clock time of each stage of one step, synchronised between stages,
    and the step's conv + linear work: each layer's forward counted by a
    hook, and in the backward its forward's work once more for its weight's
    gradient where the weight trains and once more for its input's gradient
    where the input carries one (none below the frozen layers: C4's conv1 and
    conv2, VGG16's blocks 1-2)."""
    fwd = layer_flops(det, lambda: det.loss_fn(*batch, gen), backward=True)
    opt.zero_grad()
    (total, _), t_fwd = timed(lambda: det.loss_fn(*batch, gen))
    _, t_bwd = timed(total.backward)
    _, t_opt = timed(opt.step)
    tflop = fwd / 1e12
    step_ms = t_fwd + t_bwd + t_opt
    print(f"{describe(det.model_type, det.backbone_name, det.cfg)} {dtype_name(det)} train "
          f"stages, batch {batch[0].shape[0]} at "
          f"{tuple(batch[0].shape[1:3])}: forward + proposals + targets {t_fwd:.2f} ms, "
          f"backward {t_bwd:.2f} ms, optimizer {t_opt:.2f} ms; conv + linear work "
          f"{tflop:.4f} TFLOP per step, {tflop / step_ms * 1e3:.2f} TFLOP/s over the step, "
          f"{tflop / step_ms * 1e3 / (peak_flop_per_s(det) / 1e12):.3f} of the "
          f"{dtype_name(det)} peak  ({card})")


@torch.no_grad()
def calibrate_frozen_bn(det, forward):
    """Set every FrozenBatchNorm's statistics to its input's per-channel mean
    and variance in one call of `forward`, in forward order, as a pretrained
    network's would normalize. Without it, random weights and caffe-scaled
    pixels give activations that grow through the 50 layers, logits in the
    hundreds, and training steps that diverge."""

    def hook(bn, inputs):
        x = inputs[0].float()
        bn.moving_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.moving_variance.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in det.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        forward()
    finally:
        for h in handles:
            h.remove()


def drive_training(model_type, card, dtype="float32", backbone="resnet50", steps=None,
                   data_type="pascal"):
    """Training at full width, stock config, seeded random weights: 8 steps
    at B=1 (landscape and portrait interleaved), 3 at B=4 (landscape); FPN
    also 2 at B=1 with `tpu_roi_align_fused_levels` False. Under bfloat16
    compute `BF16_STEPS` of each, parameters and momentum checked float32,
    and for Faster R-CNN the peak memory of a B=4 step with and without
    `tpu_remat`. `steps` = (B=1, B=4, per level) overrides the counts. The
    frozen parameters (C4's conv1 and conv2, VGG16's blocks 1-2) must keep
    their bits. `data_type` "coco" takes the COCO config (12 anchors a cell,
    81 classes). Returns ({path: launch counts}, the B=1 median step ms)."""
    cfg = dict(config_factory(data_type, model_type), tpu_compute_dtype=dtype)
    bf16 = dtype == "bfloat16"
    check_training_against_cpu(model_type, cfg, card, backbone)
    det = model_factory(model_type, backbone, cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, det)
    step = make_train_step(det, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    items = make_train_items(num_classes=cfg["num_classes"])
    n1, n4, n_per_level = steps or (BF16_STEPS if bf16 else (len(items), 3, 2))
    b1 = [train_batch([it], cfg, rng) for it in items[:n1]]
    landscape = [it for it in items if it[0].shape[0] < it[0].shape[1]][:BATCH]
    b4 = [train_batch(landscape, cfg, rng) for _ in range(n4)]
    if model_type == "fpn":  # conv5 is inside the extractor
        calibrate_frozen_bn(det, lambda: det.extractor(b4[0][0]))
    elif backbone != "vgg16":  # the backbone, then the conv5 RoI head on the sampled rois
        calib = torch.Generator(device="cuda").manual_seed(1)
        calibrate_frozen_bn(det, lambda: det.loss_fn(*b4[0], calib))
    frozen = {n: p.detach().clone() for n, p in det.named_parameters() if not p.requires_grad}
    step(b1[0], gen)  # warm-up: cuDNN algorithm choice, allocator
    step(b4[0], gen)
    suffix = "_bf16" if bf16 else ""
    name = (PATH_NAME[model_type] + (f"_{backbone}" if backbone != "resnet50" else "")
            + ("_coco" if data_type == "coco" else "") + suffix)
    paths, b1_ms = {}, None
    for path, batches in ((f"{name}_train_b1", b1), (f"{name}_train_b4", b4)):
        paths[path], ms = train_path(path, step, batches, gen, cfg,
                                     PER_STEP[model_type + suffix], card)
        b1_ms = ms if b1_ms is None else b1_ms
    for batch in (b1[0], b4[0]):
        train_stages(det, opt, batch, gen, card)
    device_profile(lambda: step(b1[0], gen), card)
    if model_type == "fpn":
        det.cfg["tpu_roi_align_fused_levels"] = False
        step(b1[1], gen)  # warm-up of the per-level path
        paths[f"{name}_train_per_level"] = train_path(
            f"{name}_train_per_level", step, b1[:n_per_level], gen, cfg,
            PER_STEP["fpn_per_level" + suffix], card)[0]
        device_profile(lambda: step(b1[0], gen), card)
    now = dict(det.named_parameters())
    require(all(torch.equal(now[n], t) for n, t in frozen.items()),
            f"{name}: a frozen parameter changed")
    print(f"{name}: the {len(frozen)} frozen parameters "
          f"({sorted({n.split('.')[1].split('_')[0] for n in frozen})}) kept their bits over "
          f"the steps")
    if bf16:
        require({p.dtype for p in det.parameters()} == {torch.float32}
                and {t.dtype for t in opt.trace.values()} == {torch.float32},
                f"{name}: parameters or momentum traces are not float32")
        print(f"{name}: after the steps every parameter ({len(list(det.parameters()))}) and "
              f"momentum trace ({len(opt.trace)}) is float32")
        if model_type == "faster_rcnn":
            remat_peak_memory(det, step, b4[0], gen, card)
    del det, opt, step
    torch.cuda.empty_cache()
    return paths, b1_ms


def drive_batch(path, model_type, backbone, cfg, requests, card):
    """One served batch: the first BATCH landscape requests through
    `im_detect_batch` and `post_ops_prediction`, float32, after a warm-up
    call; launches (K1 once for the batch's RPN NMS and once an image, FPN
    K4 once) set to 0 before and checked after; detections checked; batch
    time and peak memory printed. Returns the launches."""
    det = model_factory(model_type, backbone, cfg, device="cuda", seed=0)
    pre = [preprocess_eval_image(img, cfg) for img in requests]
    bucket_h = min(b[0] for b in cfg["tpu_image_buckets"])
    land = [p for p in pre if p[0].shape[0] == bucket_h][:BATCH]
    images = torch.as_tensor(np.stack([p[0] for p in land]), device="cuda")
    hws = torch.as_tensor(np.stack([p[1] for p in land]), device="cuda").long()
    scales = torch.as_tensor([p[2] for p in land], dtype=torch.float32, device="cuda")
    # statistics of a pretrained network's kind: uncalibrated, the random
    # residual stream grows ~2x a block over ResNet-152's 50
    calibrate_frozen_bn(det, lambda: det.im_detect_batch(images, hws, scales))
    det.im_detect_batch(images, hws, scales)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    raw = det.im_detect_batch(images, hws, scales)
    results = {i: post_process([t[i] for t in raw], land[i], cfg, det.num_classes)
               for i in range(BATCH)}
    launches = launch_counts()
    check_detections(results, BATCH, cfg["max_objects_per_image"])
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = 1 + BATCH
    expected["roi_align_multilevel"] = 1 if model_type == "fpn" else 0
    print(f"{path} kernel launches in one served batch: {launches} (expected {expected})")
    require(launches == expected, f"{path} launches {launches} != expected {expected}")
    batch_ms = cuda_ms(lambda: det.im_detect_batch(images, hws, scales), iters=3)
    size = "x".join(map(str, images.shape[1:3]))
    tflop = layer_flops(det, lambda: det.im_detect_batch(images, hws, scales)) / 1e12
    print(f"{path} im_detect_batch b{BATCH} {size}: {batch_ms:.2f} ms/batch = "
          f"{BATCH * 1e3 / batch_ms:.3f} images/s; conv + linear work {tflop:.4f} TFLOP, "
          f"{tflop / batch_ms * 1e3 / (F32_FLOP_PER_S / 1e12):.3f} of the float32 peak; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({card})")
    del det
    torch.cuda.empty_cache()
    return launches


def drive_slim(requests, card):
    """FPN ResNet-50 with `tpu_fpn_backbone_style: "slim"`: `predict` and one
    training loss and backward on the card against the port's CPU path, one
    served batch (K1, K4) and one B=1 training step at full width (K1, K4,
    K5). Returns {path: launches}."""
    cfg = dict(config_factory("pascal", "fpn"), tpu_fpn_backbone_style="slim")
    # the slim extractor's he-normal init saturates the random RPN scores at
    # 1.0 on these inputs: both sides take the input's statistics first
    check_against_cpu("fpn", cfg, card, calibrate=True)
    slim_step_against_cpu(cfg, card)
    paths = {"fpn_slim": drive_batch("fpn_slim", "fpn", "resnet50", cfg, requests, card)}
    det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
    require(type(det.extractor).__name__ == "SlimResNetBackbone",
            f"fpn_slim extractor {type(det.extractor).__name__}")
    step = make_train_step(det, make_optimizer(cfg, det))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    b1 = [train_batch([it], cfg, rng) for it in make_train_items()[:1]]
    calibrate_frozen_bn(det, lambda: det.extractor(b1[0][0]))
    step(b1[0], gen)  # warm-up at the timed step's shape: cuDNN algorithm choice
    paths["fpn_slim_train_b1"] = train_path("fpn_slim_train_b1", step, b1, gen, cfg,
                                            PER_STEP["fpn"], card)[0]
    del det, step
    torch.cuda.empty_cache()
    return paths


def remat_peak_memory(det, step, batch, gen, card):
    """Peak device memory and time of one B=4 step without and with
    `tpu_remat` (the extractor's activations recomputed in the backward)."""
    out = {}
    for remat in (False, True):
        det.cfg["tpu_remat"] = remat
        step(batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        out[remat] = ((time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated() / 2**30)
    det.cfg["tpu_remat"] = False
    print(f"{describe(det.model_type, det.backbone_name)} {dtype_name(det)} one "
          f"B={batch[0].shape[0]} step at "
          f"{tuple(batch[0].shape[1:3])}: peak device memory {out[False][1]:.2f} GiB without "
          f"tpu_remat, {out[True][1]:.2f} GiB with it; step {out[False][0]:.2f} ms and "
          f"{out[True][0]:.2f} ms  ({card})")


# --------------------------------------------------------------- VOC eval
def voc_annotation(image_id, h, w, objects) -> str:
    """A VOC annotation XML: objects (class name, [x1, y1, x2, y2] 1-based)."""
    objs = "".join(
        f"<object><name>{name}</name><pose>Unspecified</pose><truncated>0</truncated>"
        f"<difficult>0</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
        f"<ymax>{y2}</ymax></bndbox></object>" for name, (x1, y1, x2, y2) in objects)
    return (f"<annotation><filename>{image_id}.jpg</filename><size><width>{w}</width>"
            f"<height>{h}</height><depth>3</depth></size>{objs}</annotation>")


def write_voc_layout(root: Path, requests, seed: int = 0):
    """`Annotations/*.xml` and `ImageSets/Main/test.txt` for the requests,
    1-8 boxes each from a seeded generator -> (image ids, {id: objects})."""
    rng = np.random.RandomState(seed)
    (root / "Annotations").mkdir(parents=True)
    (root / "ImageSets" / "Main").mkdir(parents=True)
    ids, truth = [], {}
    for k, img in enumerate(requests):
        h, w = img.shape[:2]
        image_id = f"{k:06d}"
        objects = []
        for _ in range(rng.randint(1, 9)):
            x1, y1 = rng.randint(1, w - 40), rng.randint(1, h - 40)
            box = [x1, y1, rng.randint(x1 + 20, w + 1), rng.randint(y1 + 20, h + 1)]
            objects.append((PASCAL_CLASSES[rng.randint(20)], box))
        (root / "Annotations" / f"{image_id}.xml").write_text(voc_annotation(image_id, h, w,
                                                                             objects))
        ids.append(image_id)
        truth[image_id] = objects
    (root / "ImageSets" / "Main" / "test.txt").write_text("".join(f"{i}\n" for i in ids))
    return ids, truth


def voc_map(root: Path, fmt: str, classes) -> dict:
    """{class: AP} of the result files `fmt` against the layout's XMLs
    (area under the precision-recall curve)."""
    return {c: voc_eval(fmt, str(root / "Annotations" / "{}.xml"),
                        str(root / "ImageSets" / "Main" / "test.txt"), c,
                        str(root / f"cache_{Path(fmt).parent.name}"), 0.5, False)[2]
            for c in classes}


def check_result_files(paths, ids, sizes, cap):
    """Every line of the per-class files parses back: a known image id, a
    score in [0, 1], 1-based corners inside the raw image; at most `cap`
    lines an image. Returns the number of detections."""
    per_image = dict.fromkeys(ids, 0)
    for path in paths:
        for line in Path(path).read_text().splitlines():
            f = line.split(" ")
            require(len(f) == 6 and f[0] in per_image, f"result line {line!r}")
            score, x1, y1, x2, y2 = map(float, f[1:])
            h, w = sizes[f[0]]
            require(0.0 <= score <= 1.0 and 1.0 <= x1 <= x2 <= w and 1.0 <= y1 <= y2 <= h,
                    f"result line {line!r} outside image {h}x{w}")
            per_image[f[0]] += 1
    require(max(per_image.values()) <= cap, f"detections per image {per_image}")
    return sum(per_image.values())


def drive_voc_eval(requests, card):
    """The VOC eval path on the card: Faster R-CNN ResNet-50 at full width
    (seeded random weights, stock config) over a synthetic VOC layout of the
    8 requests: `preprocess_eval_image` on the arrays (JPEG decoding is
    tested on the CPU), `get_prediction_files` (batch 4) -> per-class files
    -> `voc_eval` against the XMLs. K1 once per batch (the RPN NMS) and once
    per image (`eval_post_process`, the 20 classes in one call); the files
    parse back; the mAP is finite in [0, 1]; the ground truth written as
    detections scores AP 1.0 exactly for every class present. Returns {path:
    launch counts}."""
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "VOC2007"
        ids, truth = write_voc_layout(root, requests)
        sizes = {i: img.shape[:2] for i, img in zip(ids, requests)}
        (root / "results").mkdir()
        fmt = str(root / "results" / "det_test_{}.txt")
        items = [preprocess_eval_image(img, cfg) for img in requests]
        get_prediction_files(det, iter(items), ids, fmt, batch_size=BATCH)  # warm-up
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths = get_prediction_files(det, iter(items), ids, fmt, batch_size=BATCH)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t) * 1e3
        launches = launch_counts()
        buckets = {tuple(it[0].shape[:2]) for it in items}
        batches = sum(-(-sum(tuple(it[0].shape[:2]) == b for it in items) // BATCH)
                      for b in buckets)
        expected = dict.fromkeys(KERNELS, 0)
        expected["nms_alive_sorted"] = batches + len(items)
        print(f"frcnn_voc_eval: kernel launches {launches} (expected {expected}: {batches} "
              f"batches, {len(items)} images)")
        require(launches == expected, f"frcnn_voc_eval launches {launches} != {expected}")
        n_dets = check_result_files(paths, ids, sizes, 50)
        present = sorted({name for objs in truth.values() for name, _ in objs})
        aps = voc_map(root, fmt, present)
        m = float(np.mean(list(aps.values())))
        require(np.isfinite(m) and 0.0 <= m <= 1.0, f"frcnn_voc_eval mAP {m}")
        # the ground truth as detections (0-based corners, score 1) scores 1.0
        gt = [[np.asarray([[x1 - 1, y1 - 1, x2 - 1, y2 - 1, 1.0] for name, (x1, y1, x2, y2)
                           in truth[i] if name == c], np.float64).reshape(-1, 5)
               for c in PASCAL_CLASSES] for i in ids]
        (root / "truth").mkdir()
        gt_fmt = str(root / "truth" / "gt_{}.txt")
        write_voc_detection_files(gt, ids, PASCAL_CLASSES, gt_fmt)
        gt_aps = voc_map(root, gt_fmt, present)
        require(all(ap == 1.0 for ap in gt_aps.values()), f"ground truth APs {gt_aps}")
    print(f"frcnn_voc_eval: {len(ids)} images of 1-8 boxes, {len(present)} classes present, "
          f"{n_dets} detections in {len(paths)} result files (parsed back), mAP over the "
          f"present classes {m:.4f} (random weights), ground truth as detections: AP 1.0 for "
          f"all {len(present)} classes; get_prediction_files {eval_ms:.1f} ms for "
          f"{len(ids)} images incl. host post-processing and file writes  ({card})")
    del det
    torch.cuda.empty_cache()
    return {"frcnn_voc_eval": launches}


# ------------------------------------------------------------------ trainer
TRAINER_TRAIN, TRAINER_TEST = 16, 16  # the rehearsal tree's splits (seed 0 covers 20 classes)
TRAINER_STEPS = 12
TRAINER_LR = 2.5e-4  # the rehearsal's learning rate: the stock 1e-3 diverges from random weights
TRAINER_EVAL_BATCH = 8
PREDICT_LAUNCHES = {  # one `predict` (the summary step's overlay): RPN NMS, class NMS, K4
    "fpn": {"nms_alive_sorted": 2, "roi_align_multilevel": 1},
    "faster_rcnn": {"nms_alive_sorted": 2},
}


def write_rehearsal_tree(root: Path):
    """The procedural rehearsal tree (600x800 JPEGs, seed 0) and its
    trainval TFRecords -> (VOC2007 path, TFRecord paths)."""
    voc = root / "VOCdevkit" / "VOC2007"
    t = time.perf_counter()
    generate(str(voc), TRAINER_TRAIN, TRAINER_TEST, seed=0)
    records = create_pascal_tf_records(str(root / "VOCdevkit"), "2007", "trainval",
                                       str(root / "tfrecords"), num_shards=2)
    print(f"rehearsal tree: {TRAINER_TRAIN} trainval + {TRAINER_TEST} test images at "
          f"600x800 and {len(records)} TFRecord shards in {time.perf_counter() - t:.1f} s")
    return voc, records


def trainer_config(model_type, data_type="pascal"):
    cfg = dict(config_factory(data_type, model_type))
    scale = TRAINER_LR / cfg["learning_rate_multi_lrs"][0]
    cfg["learning_rate_multi_lrs"] = [lr * scale for lr in cfg["learning_rate_multi_lrs"]]
    return cfg


def trainer_profile(trainer, batches, steps, card):
    """`steps` trainer iterations (pipeline -> copy -> step) under
    torch.profiler, with no synchronise of its own: per step the wall time,
    the device busy time, the host's wait for the next batch and the kernels
    launched, so the idle share splits into data, launches and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    waited = []

    def timed_batches():
        while True:
            t = time.perf_counter()
            item = next(batches)
            waited.append(time.perf_counter() - t)
            yield item

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_one_epoch(timed_batches(), steps=steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / steps
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / steps
    copies = sum(e.self_device_time_total for e in device if "Memcpy" in e.key) / 1e3 / steps
    kernels = sum(e.count for e in device if "Memcpy" not in e.key and "Memset" not in e.key)
    launch = [e for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                             "cudaLaunchKernelExC", "cuLaunchKernelEx")]
    launch_ms = sum(e.self_cpu_time_total for e in launch) / 1e3 / steps
    wait = sum(waited) * 1e3 / steps
    if busy == 0:
        print(f"trainer profile: no device time recorded; idle share not measured  ({card})")
        return None
    print(f"trainer profile, {steps} steps: per step wall {wall:.2f} ms, device busy {busy:.2f} "
          f"ms (host-to-device copies {copies:.3f}), idle share {1 - busy / wall:.3f}; host wait "
          f"for the next batch {wait:.2f} ms, {kernels / steps:.0f} kernels launched "
          f"({launch_ms:.2f} ms of host launch calls)  ({card})")
    return 1 - busy / wall


def train_and_restore(model_type, cfg, data_type, data_cfg, logs, name, bare_ms, card):
    """`Trainer.train` at full width, B=1: TRAINER_STEPS steps over
    `dataset_factory(data_type, "train", data_cfg)` (prefetch; a checkpoint
    at the last step), launches and sample counts checked -> a fresh
    `Trainer` on the same directory restores bit-equal parameters, traces
    and step -> one more step of each on one batch and one set of draws
    gives equal losses. Returns (the trainer, its plain step function, the
    launch counts of the steps)."""
    det = model_factory(model_type, "resnet50", cfg, device="cuda")
    trainer = Trainer(det, logs, logging_every_n_steps=TRAINER_STEPS // 2,
                      summary_every_n_steps=TRAINER_STEPS, saving_every_n_steps=TRAINER_STEPS,
                      seed=0)
    plain_step = trainer.step_fn
    ends, metrics = [], []

    def timed_step(batch, draws):
        out = plain_step(batch, draws)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in out.items()})
        return out

    trainer.step_fn = timed_step
    reset_launches()
    trainer.train(dataset_factory(data_type, "train", data_cfg), 1, TRAINER_STEPS)
    launches = launch_counts()
    expected = {k: PER_STEP[model_type].get(k, 0) * TRAINER_STEPS
                + PREDICT_LAUNCHES[model_type].get(k, 0) for k in KERNELS}
    print(f"{name}_trainer: kernel launches {launches} (expected {expected}: {TRAINER_STEPS} "
          f"steps and the summary step's predict)")
    require(launches == expected, f"{name}_trainer launches {launches} != expected {expected}")
    require(len(metrics) == TRAINER_STEPS and trainer.step == TRAINER_STEPS,
            f"{name}_trainer: {len(metrics)} steps, count {trainer.step}")
    for i, m in enumerate(metrics):
        require(all(np.isfinite(v) for v in m.values()), f"{name}_trainer step {i + 1}: {m}")
        require(m["num_rpn_fg"] + m["num_rpn_bg"] == cfg["rpn_total_sample_number"]
                and m["num_rpn_fg"] > 0, f"{name}_trainer step {i + 1}: sample counts {m}")
    ckpts = sorted(os.listdir(logs))
    require(f"ckpt_{TRAINER_STEPS:08d}.pt" in ckpts, f"{name}_trainer checkpoints {ckpts}")
    med = float(np.median(np.diff(ends))) * 1e3
    recorded = RECORDED_BARE_STEP_MS.get(name)
    print(f"{name}_trainer: {TRAINER_STEPS} steps at B=1 from {data_type} JPEGs, step wall time "
          f"(pipeline, copy, step; one synchronise a step) median {med:.2f} ms = "
          f"{1e3 / med:.3f} images/s, against {bare_ms:.2f} ms for the bare step of this run's "
          f"{name}_train_b1"
          + (f" (recorded earlier: {recorded} ms)" if recorded else "") + "; losses step 1 "
          f"{metrics[0]['total_loss']:.4f}, step {TRAINER_STEPS} "
          f"{metrics[-1]['total_loss']:.4f}  ({card})")

    # a fresh trainer restores the checkpoint bit for bit
    det2 = model_factory(model_type, "resnet50", cfg, device="cuda", seed=1)
    restored = Trainer(det2, logs, seed=0)
    require(restored.step == TRAINER_STEPS, f"restored step {restored.step}")
    state, state2 = det.state_dict(), det2.state_dict()
    require(all(torch.equal(state[k], state2[k]) for k in state), "restored params differ")
    require(all(torch.equal(t, restored.optimizer.trace[k])
                for k, t in trainer.optimizer.trace.items()), "restored traces differ")
    # one more step of each on the same batch and draws: equal losses
    batches = dataset_factory(data_type, "train", dict(data_cfg, seed=1))
    batch = next(batches)
    batches.close()
    cont = [{k: float(v) for k, v in t.step_fn(t._to_device(batch),
                                                torch.Generator(det.device).manual_seed(7))
             .items()} for t in (trainer, restored)]
    require(cont[0] == cont[1], f"continued step: {cont[0]} vs restored {cont[1]}")
    print(f"{name}_trainer: a fresh Trainer restored step {TRAINER_STEPS} with bit-equal "
          f"parameters ({len(state)} tensors), traces ({len(trainer.optimizer.trace)}) and "
          f"count; the next step of both on one batch and one set of draws gives equal losses "
          f"(total {cont[0]['total_loss']:.6f})")
    del det2, restored
    return trainer, plain_step, launches


def drive_trainer(model_type, voc, records, bare_ms, card):
    """The trainer path at full width (stock Pascal config, the rehearsal's
    learning rate, B=1): `dataset_factory` batches from JPEG TFRecords ->
    `Trainer.train` (prefetch; a checkpoint at the last step) -> a fresh
    `Trainer` on the same directory restores bit-equal parameters, traces
    and step -> one more step of each on one batch and one set of draws
    gives equal losses -> `eval_pascal` from the checkpoint over the test
    JPEGs writes 20 result files and 20 APs in [0, 1]. Returns {path:
    launch counts}."""
    cfg = trainer_config(model_type)
    name = PATH_NAME[model_type]
    logs = str(voc.parent.parent / f"logs_{model_type}")
    data_cfg = {"model_config": cfg, "tf_records_list": records, "batch_size": 1, "seed": 0}
    trainer, plain_step, launches = train_and_restore(model_type, cfg, "pascal", data_cfg, logs,
                                                      name, bare_ms, card)

    # the eval command line from the checkpoint over the test JPEGs
    result_dir = str(voc.parent.parent / f"results_{model_type}")
    argv = [logs, "--root_path", str(voc), "--model_type", model_type, "--mode", "test",
            "--result_dir", result_dir, "--batch_size", str(TRAINER_EVAL_BATCH)]
    reset_launches()
    t = time.perf_counter()
    aps = eval_pascal.main(argv)
    eval_s = time.perf_counter() - t
    eval_launches = launch_counts()
    batches_n = -(-TRAINER_TEST // TRAINER_EVAL_BATCH)
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = batches_n + TRAINER_TEST
    if model_type == "fpn":
        expected["roi_align_multilevel"] = batches_n
    print(f"{name}_trainer_eval: kernel launches {eval_launches} (expected {expected}: "
          f"{batches_n} batches, {TRAINER_TEST} images)")
    require(eval_launches == expected, f"{name}_trainer_eval launches {eval_launches}")
    files = [f for f in os.listdir(result_dir) if f.endswith(".txt")]
    require(sorted(files) == sorted(f"{c}.txt" for c in PASCAL_CLASSES), f"result files {files}")
    require(len(aps) == 20 and all(0.0 <= ap <= 1.0 for ap in aps), f"APs {aps}")
    print(f"{name}_trainer_eval: eval_pascal from the step-{TRAINER_STEPS} checkpoint over "
          f"{TRAINER_TEST} test JPEGs in {eval_s:.2f} s (model build, restore, decode, "
          f"inference, files, voc_eval), 20 result files, 20 APs in [0, 1], mAP "
          f"{float(np.mean(aps)):.4f} after {TRAINER_STEPS} steps from random weights  ({card})")

    # the idle share of trainer steps with the input pipeline
    trainer.step_fn = plain_step
    trainer.logging_every = trainer.summary_every = 10**9  # no read-back in the window
    pipeline = prefetch(dataset_factory("pascal", "train", dict(data_cfg, seed=2)))
    trainer.train_one_epoch(pipeline, steps=2)  # warm-up, fills the queue
    trainer_profile(trainer, pipeline, 4, card)
    pipeline.close()
    del trainer
    torch.cuda.empty_cache()
    return {f"{name}_trainer": launches, f"{name}_trainer_eval": eval_launches}


def drive_coco_trainer(root: Path, bare_ms, card):
    """The COCO trainer and eval paths at full width (stock COCO config at
    the rehearsal's learning rate, B=1): the port's `coco_rehearsal.generate`
    writes 16 train and 16 val procedural 600x800 JPEGs and their instances
    JSONs; `train_and_restore` over `dataset_factory("coco", "train", ...)`
    (`frcnn_coco_trainer`); `eval_coco.main` from the checkpoint over the
    val JPEGs (`frcnn_coco_eval`: K1 once a batch and once an image at
    [80, 300] -> 100) writes a results JSON that parses, with 12 stats in
    [-1, 1]; the non-crowd ground truth written as detections scores AP
    @[.50:.95] exactly 1.0. Returns {path: launch counts}."""
    t = time.perf_counter()
    generate_coco(str(root), TRAINER_TRAIN, TRAINER_TEST, seed=0)
    images, train_json, val_json = (str(root / "images"), str(root / "instances_train.json"),
                                    str(root / "instances_val.json"))
    print(f"COCO rehearsal set: {TRAINER_TRAIN} train + {TRAINER_TEST} val images at 600x800 "
          f"in {time.perf_counter() - t:.1f} s")
    cfg = trainer_config("faster_rcnn", "coco")
    logs = str(root / "logs")
    data_cfg = {"model_config": cfg, "annotation_file": train_json, "image_dir": images,
                "batch_size": 1, "seed": 0}
    trainer, _, launches = train_and_restore("faster_rcnn", cfg, "coco", data_cfg, logs,
                                             "frcnn_coco", bare_ms, card)
    del trainer
    torch.cuda.empty_cache()

    results_json = str(root / "results.json")
    argv = [logs, "--annotation_file", val_json, "--image_dir", images, "--results_json",
            results_json, "--batch_size", str(TRAINER_EVAL_BATCH)]
    n_images = len(CocoDataset(val_json, images))
    reset_launches()
    with NmsShapes() as shapes:
        t = time.perf_counter()
        stats = eval_coco.main(argv)
        eval_s = time.perf_counter() - t
    eval_launches = launch_counts()
    batches_n = -(-n_images // TRAINER_EVAL_BATCH)  # every image in the 608x1008 bucket
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = batches_n + n_images
    print(f"frcnn_coco_eval: kernel launches {eval_launches} (expected {expected}: "
          f"{batches_n} batches, {n_images} images)")
    require(eval_launches == expected, f"frcnn_coco_eval launches {eval_launches}")
    shapes.check("frcnn_coco_eval", {
        (TRAINER_EVAL_BATCH, cfg["rpn_proposal_test_pre_nms_sample_number"],
         cfg["rpn_proposal_test_after_nms_sample_number"]): batches_n,
        (80, cfg["rpn_proposal_test_after_nms_sample_number"], 100): n_images})
    with open(val_json) as f:
        gt = json.load(f)
    results, per_image = coco_results(results_json, gt)
    require(stats.shape == (12,) and bool(((stats >= -1) & (stats <= 1)).all()),
            f"COCO stats {stats}")
    print(f"frcnn_coco_eval: eval_coco from the step-{TRAINER_STEPS} checkpoint over "
          f"{n_images} val JPEGs in {eval_s:.2f} s (model build, restore, decode, inference, "
          f"post-processing, JSON, evaluation), {len(results)} results (at most "
          f"{max(per_image.values())} an image), {len({r['category_id'] for r in results})} "
          f"categories detected, AP @[.50:.95] {stats[0]:.4f}, AP @.50 {stats[1]:.4f} after "
          f"{TRAINER_STEPS} steps from random weights  ({card})")
    # the same command line from the seeded detector before training, whose
    # serving path detects (the 12 steps above may leave no detection at all,
    # and then no result reaches the JSON)
    init = str(root / "init.npz")
    save_params(init, model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=0))
    argv[0], argv[argv.index(results_json)] = init, str(root / "init_results.json")
    init_stats = eval_coco.main(argv)
    results, per_image = coco_results(str(root / "init_results.json"), gt)
    require(len(results) > 0 and bool(((init_stats >= -1) & (init_stats <= 1)).all()),
            f"results of the untrained detector: per image {per_image}, stats {init_stats}")
    truth = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
              "score": 1.0} for a in gt["annotations"] if not a["iscrowd"]]
    gt_stats = evaluate_coco_detections(val_json, truth)
    require(gt_stats[0] == 1.0, f"ground truth as detections: stats {gt_stats}")
    print(f"frcnn_coco_eval: from the untrained detector {len(results)} results (per image "
          f"{min(per_image.values())}..{max(per_image.values())}), "
          f"{len({r['category_id'] for r in results})} categories, parsed back; the ground "
          f"truth as detections: AP @[.50:.95] 1.0  ({card})")
    return {"frcnn_coco_trainer": launches, "frcnn_coco_eval": eval_launches}


def coco_results(path, gt):
    """A results JSON of `eval_coco` parsed back and checked against the
    ground truth's images and COCO's category ids -> (results, {image id:
    results}), at most 100 an image."""
    with open(path) as f:
        results = json.load(f)
    ids = {img["id"] for img in gt["images"]}
    per_image = dict.fromkeys(ids, 0)
    for r in results:
        x, y, w, h = r["bbox"]
        require(r["image_id"] in ids and r["category_id"] in COCO_CAT_IDS
                and 0.0 <= r["score"] <= 1.0 and np.isfinite([x, y, w, h]).all()
                and w > 0 and h > 0 and x >= 0 and y >= 0, f"result {r}")
        per_image[r["image_id"]] += 1
    require(max(per_image.values()) <= 100, f"results per image {per_image}")
    return results, per_image


# ------------------------------------------------ importers, Adam, debug APIs
IMPORT_SEED = 12
# the first conv of a synthetic checkpoint reads caffe-range pixels (+-128):
# its He-scaled kernel times this keeps the activations of the order of 1
IMPORT_PIXEL_GAIN = 1.0 / 64.0
# the prediction layers of a synthetic checkpoint take the reference's init
# stds, not He's: He-scaled box deltas would clip every proposal
HEAD_STD = {"rpn_score_conv": 0.01, "rpn_bbox_conv": 0.001, "roi_head_score": 0.01,
            "roi_head_bboxes": 0.001}
BN_LEAVES = ("gamma", "beta", "moving_mean", "moving_variance")
ADAM_STEPS = 8  # full-size FPN B=1 steps with optimizer_type='adam', as fpn_train_b1's 8


def synthetic_checkpoint(tree, name_map, seed, stored_shapes=None):
    """A third-party checkpoint's tensors over the port's flax-layout `tree`
    (`importers.params_tree`), named by `name_map` ({prefix: (module,
    layer)}) and in the reference's layouts: HWIO conv and [in, out] dense
    weights, He-scaled (the first conv's times IMPORT_PIXEL_GAIN; the
    prediction layers with HEAD_STD); slim
    ResNet convs without biases (a BatchNorm follows them), every other
    layer with biases; BatchNorm gamma U(0.8, 1.2) (times 0.2 on a
    bottleneck's last, so that the residual stream stays of the order of its
    input), beta and mean N(0, 0.1), variance U(0.5, 1.5).
    `stored_shapes` {prefix: shape}: a weight the checkpoint stores in
    another shape than the port's (slim's fc6 / fc7 convs)."""
    rng = np.random.default_rng(seed)
    stored_shapes = stored_shapes or {}
    out = {}
    for prefix, (module, layer) in name_map.items():
        target = tree[module][layer]
        if "gamma" in target:
            n = target["gamma"].shape
            gain = 0.2 if layer.endswith("_3_bn") else 1.0
            out[prefix + "gamma"] = (rng.uniform(0.8, 1.2, n) * gain).astype(np.float32)
            out[prefix + "beta"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
            out[prefix + "moving_mean"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
            out[prefix + "moving_variance"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            continue
        shape = stored_shapes.get(prefix, target["kernel"].shape)
        std = HEAD_STD.get(layer, (2.0 / np.prod(shape[:-1])) ** 0.5)
        if layer in ("conv1_conv", "block1_conv1"):
            std *= IMPORT_PIXEL_GAIN
        out[prefix + "weights"] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        if not (layer.endswith("_conv") and layer[: -len("_conv")] + "_bn" in tree[module]):
            out[prefix + "biases"] = (rng.standard_normal(target["bias"].shape)
                                      * 0.01).astype(np.float32)
    return out


def expected_state(start, tensors, name_map, flips=()):
    """The state_dict that importing `tensors` must leave, derived without
    the importer: conv weights HWIO -> OIHW (a `flips` layer's input
    channels, OIHW axis 1, reversed), dense weights (slim's fc6 / fc7 convs
    flattened in (h, w, c) order) transposed to [out, in], a missing bias
    zero, BatchNorm statistics as they are, every other entry as in `start`."""
    want = dict(start)
    for prefix, (module, layer) in name_map.items():
        key = f"{module}.{layer}"
        if prefix + "gamma" in tensors:
            for leaf in BN_LEAVES:
                want[f"{key}.{leaf}"] = torch.from_numpy(tensors[prefix + leaf])
            continue
        w = tensors[prefix + "weights"]
        if want[f"{key}.weight"].ndim == 4:
            w = torch.from_numpy(w).permute(3, 2, 0, 1)
            if (module, layer) in flips:
                w = w.flip(1)
        else:
            w = torch.from_numpy(w.reshape(-1, w.shape[-1])).T
        want[f"{key}.weight"] = w.contiguous()
        bias = tensors.get(prefix + "biases")
        want[f"{key}.bias"] = (torch.zeros_like(start[f"{key}.bias"]) if bias is None
                               else torch.from_numpy(bias))
    return want


def import_into(det, tensors, name_map, what, card, flips=()):
    """`importers.apply_name_map` of `tensors` into the detector on the card,
    then every state_dict entry held bit-equal to `expected_state`."""
    start = {k: v.cpu().clone() for k, v in det.state_dict().items()}
    t = time.perf_counter()
    importers.load_params_tree(det, importers.apply_name_map(
        importers.params_tree(det), tensors, name_map, bgr_flip_layers=flips))
    dt = time.perf_counter() - t
    want = expected_state(start, tensors, name_map, flips)
    got = det.state_dict()
    for k, w in want.items():
        require(got[k].device.type == "cuda" and torch.equal(got[k].cpu(), w),
                f"{what}: {k} is not what the checkpoint gives")
    changed = sum(not torch.equal(start[k], w) for k, w in want.items())
    print(f"{what}: {len(tensors)} checkpoint tensors through {len(name_map)} map entries in "
          f"{dt:.2f} s; all {len(want)} state_dict entries on the card bit-equal to the "
          f"expected values ({changed} changed)  ({card})")


def drive_import(path, model_type, backbone, name_map, requests, card, image_format=None,
                 stored_shapes=None, backbone_init=False):
    """A synthetic checkpoint in the reference's layout (`name_map`) imported
    into a full-width detector on the card, its entries checked; `predict`
    on the card against the port's CPU path on the same imported weights;
    the 8 requests served at batch 4 in `image_format` with the launches
    (K1 a batch and an image, FPN K4 a batch) set to 0 before and checked
    after. With `backbone_init`, a slim `vgg_16` backbone with the conv1 BGR
    flip goes in first (a fresh run's init). Returns the launches."""
    cfg = dict(config_factory("pascal", model_type))
    det = model_factory(model_type, backbone, cfg, device="cuda", seed=0)
    tree = importers.params_tree(det)
    if backbone_init:
        slim = name_maps.vgg16_slim_backbone_map()
        import_into(det, synthetic_checkpoint(tree, slim, IMPORT_SEED + 1), slim,
                    f"{path} slim vgg_16 backbone init", card,
                    flips=(("extractor", "block1_conv1"),))
    tensors = synthetic_checkpoint(tree, name_map, IMPORT_SEED, stored_shapes)
    import_into(det, tensors, name_map, path, card)
    state = {k: v.cpu() for k, v in det.state_dict().items()}
    check_against_cpu(model_type, cfg, card, backbone, imported=state,
                      name=f"{path} (imported weights)")
    serve(det, requests, cfg, image_format)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    results, _, total, batches = serve(det, requests, cfg, image_format)
    launches = launch_counts()
    check_detections(results, len(requests), cfg["max_objects_per_image"])
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = batches + len(requests)
    expected["roi_align_multilevel"] = batches if model_type == "fpn" else 0
    print(f"{path} kernel launches serving {len(requests)} requests (image_format "
          f"{image_format}): {launches} (expected {expected})")
    require(launches == expected, f"{path} launches {launches} != expected {expected}")
    print(f"{path} serving {len(requests)} requests, batch {BATCH}, incl. host preprocessing: "
          f"{len(requests) / total:.3f} images/s  ({card})")
    del det
    torch.cuda.empty_cache()
    return launches, state


def check_pth_round_trip(state, model_type, card):
    """A `torch.save`d state_dict -> `convert_pth_to_dict` (the TF layouts)
    -> pickle -> `load_pickle_dict`: the flax-layout values of the same
    state, and back through the weight bridge into a fresh detector on the
    card, bit for bit."""
    flat = from_jax.flat_params_from_state_dict(state)
    path_of = dict(zip(state, flat))  # port name -> flax path, in state_dict order
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        torch.save({k: v.cuda() for k, v in state.items()}, os.path.join(tmp, "model.pth"))
        converted = pytorch_convert.convert_pth_to_dict(os.path.join(tmp, "model.pth"),
                                                        os.path.join(tmp, "model.pkl"))
        loaded = pytorch_convert.load_pickle_dict(os.path.join(tmp, "model.pkl"))
        dt = time.perf_counter() - t
    require(loaded.keys() == converted.keys() == state.keys(), "import_pth: names")
    for name, value in loaded.items():
        require(np.array_equal(value, flat[path_of[name]]) and
                np.array_equal(value, converted[name]), f"import_pth: {name}")
    det = model_factory(model_type, "resnet50", config_factory("pascal", model_type),
                        device="cuda", seed=7)
    from_jax.load_jax_params(det, {path_of[n]: v for n, v in loaded.items()})
    require(all(torch.equal(v.cpu(), state[k]) for k, v in det.state_dict().items()),
            "import_pth: the bridged state differs")
    print(f"import_pth: {len(state)} tensors .pth -> pickle (OIHW -> HWIO, [out, in] -> "
          f"[in, out]) -> load_pickle_dict in {dt:.2f} s, equal to the flax layout, and back "
          f"into a detector on the card bit for bit  ({card})")
    del det
    torch.cuda.empty_cache()


def drive_imports(requests, card):
    """The reference checkpoint importers on the card: tf-faster-rcnn
    ResNet-50 (`import_frcnn_tf`) and VGG16 (`import_vgg16_tf`, fc6 stored as
    [7, 7, 512, 4096], fc7 as [1, 1, 4096, 4096], after a slim `vgg_16`
    backbone init), FPN_Tensorflow ResNet-50 served with image_format "rgb"
    (`import_fpn_tf`), and a `.pth` round trip (`import_pth`)."""
    from importlib.util import find_spec

    missing = [m for m in ("h5py", "tensorflow") if find_spec(m) is None]
    print(f"importers: this machine lacks {missing or 'nothing'}; the .h5 and TF-checkpoint "
          f"readers (held against JAX on the CPU, tests/test_torch_ref_import.py) are not "
          f"run here; the tensors they would return go through the port's apply_name_map "
          f"and weight bridge on the card")
    paths = {}
    paths["import_frcnn_tf"], c4_state = drive_import(
        "import_frcnn_tf", "faster_rcnn", "resnet50", name_maps.resnet_tf_faster_rcnn_map(50),
        requests, card)
    paths["import_vgg16_tf"], _ = drive_import(
        "import_vgg16_tf", "faster_rcnn", "vgg16", name_maps.vgg16_tf_faster_rcnn_map(),
        requests, card, stored_shapes={"vgg_16/fc6/": (7, 7, 512, VGG16_HIDDEN),
                                       "vgg_16/fc7/": (1, 1, VGG16_HIDDEN, VGG16_HIDDEN)},
        backbone_init=True)
    cfg = config_factory("pascal", "fpn")
    bgr, rgb = (preprocess_eval_image(requests[0], cfg, image_format=f)[0]
                for f in (None, "rgb"))
    require(not np.array_equal(bgr, rgb) and np.allclose(rgb, bgr[..., ::-1], atol=1e-4),
            "import_fpn_tf: image_format 'rgb' is not the caffe input's channels reversed")
    paths["import_fpn_tf"], _ = drive_import(
        "import_fpn_tf", "fpn", "resnet50", name_maps.fpn_tensorflow_map(50), requests, card,
        image_format="rgb")
    check_pth_round_trip(c4_state, "faster_rcnn", card)
    return paths


def small_check_config(model_type, **extra):
    """The stock config cut to the 128x128 card-vs-CPU checks' sizes."""
    return dict(config_factory("pascal", model_type), tpu_image_buckets=[[128, 128]],
                image_min_size=128, image_max_size=128, **TRAIN_CPU_COMMON,
                **TRAIN_CPU_CHECK[model_type], **extra)


def small_anchors(model_type, cfg):
    if model_type == "fpn":
        return 3 * sum((-(-128 // s)) ** 2 for s in cfg["anchor_stride_list"])
    return (128 // cfg["extractor_stride"]) ** 2 * 3 * len(cfg["scales"])


def small_adam_step(device, small, draws, inputs, seed):
    """One FPN `make_train_step(..., with_probe=True)` step with Adam from
    the seeded weights (RPN score layer x20, as the training checks)."""
    det = model_factory("fpn", "resnet50", small, device=device, seed=seed)
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
    opt = make_optimizer(small, det)
    require(isinstance(opt, AdamOptimizer), "adam: make_optimizer did not give Adam")
    before = {n: p.detach().cpu().clone() for n, p in det.named_parameters()}
    metrics = make_train_step(det, opt, with_probe=True)(inputs, draws.to(device))
    return dict(
        metrics={k: float(v) for k, v in metrics.items()}, lr=opt.schedule(0), before=before,
        after={n: p.detach().cpu() for n, p in det.named_parameters()},
        grads={n: p.grad.cpu() for n, p in det.named_parameters() if p.grad is not None},
        abs_sum=float(sum(t.abs().double().sum() for t in det.state_dict().values())),
        moments={s: {n: t.cpu() for n, t in getattr(opt, s).items()} for s in ("mu", "nu")})


def adam_step_against_cpu(card):
    """One FPN Adam step at 128x128 on the card (cuDNN off) against the
    port's CPU step, same weights and draws, at a point the CPU step shows
    well-conditioned (`conditioning`): losses rtol 1e-4, counts equal,
    `probe` within 1e-5 * sum |p|; the update within 1e-3 * lr wherever
    |g| exceeds GRAD_TOL of its tensor's largest (below it the two
    gradients may differ in sign, and Adam's first update is about
    lr * sign(g)) and within 2 * lr everywhere; the moments within 1e-2 of
    their tensor's largest."""
    small = small_check_config("fpn", optimizer_type="adam")
    seed = CPU_CHECK_SEED["fpn"]
    inputs = small_train_inputs(1.0)
    draws = TrainDraws.sample(torch.Generator().manual_seed(5), 1, small_anchors("fpn", small),
                              64, 32)
    cpu = small_adam_step("cpu", small, draws, inputs, seed)
    move = conditioning("fpn adam", cpu["grads"], lambda moved: small_adam_step(
        "cpu", small, draws, moved, seed)["grads"], inputs)
    torch.backends.cudnn.enabled = False
    try:
        cuda = small_adam_step("cuda", small, draws, inputs, seed)
    finally:
        torch.backends.cudnn.enabled = True
    require(cpu["metrics"]["num_rpn_fg"] > 0, f"fpn adam: no RPN foreground {cpu['metrics']}")
    for k, v in cpu["metrics"].items():
        got = cuda["metrics"][k]
        ok = {"num": got == v, "probe": abs(got - v) <= 1e-5 * cpu["abs_sum"]}.get(
            k.split("_")[0], abs(got - v) <= 1e-4 * abs(v))
        require(ok, f"fpn adam {k}: cuda {got} vs cpu {v}")
    lr, worst, covered, total = cpu["lr"], (0.0, ""), 0, 0
    for name, g in cpu["grads"].items():
        diff = ((cuda["after"][name] - cpu["before"][name])
                - (cpu["after"][name] - cpu["before"][name])).abs()
        sure = g.abs() > GRAD_TOL * g.abs().max()
        require(float(diff.max()) <= 2 * lr, f"fpn adam update of {name}: {float(diff.max())}")
        if bool(sure.any()):
            worst = max(worst, (float(diff[sure].max()) / lr, name))
            require(worst[0] <= 1e-3, f"fpn adam update of {name}: {worst[0]} * lr")
        covered, total = covered + int(sure.sum()), total + g.numel()
    moment = (0.0, "")
    for slot, tensors in cpu["moments"].items():
        for name, t in tensors.items():
            err = float((cuda["moments"][slot][name] - t).abs().max()) / max(
                float(t.abs().max()), 1e-30)
            require(err <= 1e-2, f"fpn adam {slot} of {name}: {err}")
            moment = max(moment, (err, f"{slot} {name}"))
    print(f"fpn adam step 128x128 (seed {seed}), cuda (cuDNN off) vs the port's cpu path: "
          f"losses within rtol 1e-4 (total {cuda['metrics']['total_loss']:.6f} vs "
          f"{cpu['metrics']['total_loss']:.6f}), counts equal, probe "
          f"{cuda['metrics']['probe']:.6f} vs {cpu['metrics']['probe']:.6f}; update within "
          f"{worst[0]:.3g} * lr ({worst[1]}) on the {covered / total:.4f} of elements with "
          f"|g| > {GRAD_TOL} of the largest, within 2 * lr everywhere; moments within "
          f"{moment[0]:.3g} of their largest ({moment[1]}); the cpu alone at input x "
          f"(1 + {INPUT_MOVE:g}) moves the gradients by {move[0]:.3g} ({move[1]})  ({card})")


def drive_adam(card):
    """`adam`: the card-vs-CPU Adam step, then ADAM_STEPS full-size FPN
    ResNet-50 steps at B=1 with `optimizer_type='adam'` over the requests
    of `fpn_train_b1` (K1, K4, K5 once a step), the moments float32 and
    finite after them. Returns the launches."""
    adam_step_against_cpu(card)
    cfg = dict(config_factory("pascal", "fpn"), optimizer_type="adam")
    det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, det)
    step = make_train_step(det, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    batches = [train_batch([it], cfg, rng) for it in make_train_items()[:ADAM_STEPS]]
    calibrate_frozen_bn(det, lambda: det.extractor(batches[0][0]))
    for batch in batches[:2]:  # warm-up, landscape and portrait: cuDNN algorithms, allocator
        step(batch, gen)
    launches, ms = train_path("fpn_adam_train_b1", step, batches, gen, cfg, PER_STEP["fpn"],
                              card)
    moments = [*opt.mu.values(), *opt.nu.values()]
    require(opt.count == ADAM_STEPS + 2
            and all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in moments),
            "fpn adam: moments not float32 and finite after the steps")
    print(f"fpn_adam_train_b1: median step {ms:.2f} ms with Adam; {len(moments)} moments "
          f"float32 and finite after {opt.count} steps  ({card})")
    del det, opt, step
    torch.cuda.empty_cache()
    return {"fpn_adam_train_b1": launches}


def drive_debug(card):
    """`debug`: `predict_rpn` / `predict_roi` (C4, proposals at the training
    sizes) and `predict_rpns` / `predict_rois` (FPN, at the test sizes) on
    the card against the CPU with the same draws: anchors and positive
    masks, sampled labels and validity equal, rois and targets within 1e-3;
    then one C4 step of `make_train_step(..., with_probe=True)` on the card
    whose `probe` equals the host's float64 sum of the state_dict within
    1e-5 * sum |p|. Launches counted on the card's calls alone: K1 for each
    `predict_roi(s)` (its RPN NMS) and for the step."""
    image, hw, gt, mask, labels = small_train_inputs(1.0)
    args = (image[0], hw[0], gt[0], mask[0])
    reset_launches()
    card_launches = dict.fromkeys(KERNELS, 0)
    for model_type, (rpn, roi) in (("faster_rcnn", ("predict_rpn", "predict_roi")),
                                   ("fpn", ("predict_rpns", "predict_rois"))):
        small = small_check_config(model_type, rpn_proposal_test_pre_nms_sample_number=512,
                                   rpn_proposal_test_after_nms_sample_number=64)
        phase = "train" if model_type == "faster_rcnn" else "test"
        draws = TrainDraws.sample(
            torch.Generator().manual_seed(7), 1, small_anchors(model_type, small),
            small[f"rpn_proposal_{phase}_after_nms_sample_number"], small["roi_total_sample_number"])
        out = {}
        for device in ("cuda", "cpu"):
            det = model_factory(model_type, "resnet50", small, device=device,
                                seed=CPU_CHECK_SEED[model_type])
            with torch.no_grad():
                det.rpn_head.rpn_score_conv.weight.mul_(20.0)
            before = launch_counts()
            anchors, pos = getattr(det, rpn)(*args, draws)
            pt = getattr(det, roi)(*args, labels[0], draws)
            if device == "cuda":
                card_launches = {k: card_launches[k] + v - before[k]
                                 for k, v in launch_counts().items()}
            out[device] = (anchors.cpu(), pos.cpu(), type(pt)(*(t.cpu() for t in pt)))
        (ga, gp, gt_), (ca, cp, ct) = out["cuda"], out["cpu"]
        require(torch.equal(ga, ca) and torch.equal(gp, cp) and bool(cp.any()),
                f"{rpn}: anchors or positive masks differ")
        require(torch.equal(gt_.labels, ct.labels) and torch.equal(gt_.valid, ct.valid)
                and bool((ct.labels > 0).any()), f"{roi}: sampled labels differ")
        errs = {f: float((getattr(gt_, f) - getattr(ct, f)).abs().max())
                for f in ("rois", "bbox_targets", "in_weights", "out_weights")}
        require(max(errs.values()) <= 1e-3, f"{roi}: {errs}")
        print(f"{model_type} {rpn} / {roi} 128x128, cuda vs the port's cpu path with the same "
              f"draws: {int(cp.sum())} positive anchors of {cp.numel()} equal, "
              f"{int((ct.labels > 0).sum())} fg of {ct.labels.numel()} sampled labels equal, "
              f"rois / targets within {max(errs.values()):.3g}  ({card})")
    small = small_check_config("faster_rcnn")
    det = model_factory("faster_rcnn", "resnet50", small, device="cuda", seed=CPU_CHECK_SEED[
        "faster_rcnn"])
    draws = TrainDraws.sample(torch.Generator().manual_seed(7), 1,
                              small_anchors("faster_rcnn", small), 64, 32)
    before = launch_counts()
    metrics = make_train_step(det, make_optimizer(small, det), with_probe=True)(
        small_train_inputs(1.0), draws.to("cuda"))
    probe = float(metrics["probe"])
    card_launches = {k: card_launches[k] + v - before[k] for k, v in launch_counts().items()}
    state = [t.detach().double() for t in det.state_dict().values()]
    host, abs_sum = float(sum(t.sum() for t in state)), float(sum(t.abs().sum() for t in state))
    require(np.isfinite(probe) and abs(probe - host) <= 1e-5 * abs_sum,
            f"with_probe: probe {probe} vs the state_dict's sum {host}")
    print(f"with_probe: probe {probe:.6f}, the state_dict's float64 sum {host:.6f} (tolerance "
          f"{1e-5 * abs_sum:.3g}); debug phase launches on the card: {card_launches}  ({card})")
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = 3
    require(card_launches == expected, f"debug launches {card_launches} != expected {expected}")
    del det
    torch.cuda.empty_cache()
    return {"debug": card_launches}


# ------------------------------------------------------------------- export
EXPORT_BOX_TOL = 1e-4  # px, artifact against the detector's direct predict
EXPORT_SCORE_TOL = 1e-5
HOST_CALLS = 200  # calls per host-time measurement of an operator or its wrapper


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds of one `fn()`: `calls` calls issued back to back
    with no synchronization inside the timed loop (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def op_host_times(card) -> dict:
    """Host us of one call through each serving operator against a direct
    call of its ctypes wrapper, at the served shapes (K1 [4, 6000] -> 1000,
    the FPN RPN NMS of a batch; K4 at B=4, N=1000 on the planes of a
    640x1024 bucket), in the order op, wrapper, wrapper, op."""
    rng = np.random.RandomState(21)
    boxes, valid = nms_fixture(rng, BATCH, 6000)
    tb, tv = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    args = roi_fixture(rng, BATCH, 1000, SERVED_HWS)
    pairs = {
        "nms_alive_sorted [4,6000]->1000": (
            lambda: torch.ops.tf_eager_od.nms_alive_sorted(tb, tv, 0.7, 1000),
            lambda: NMS_KERNEL(tb, tv, 0.7, 1000)),
        "roi_align B=4 N=1000 S=14 C=256, P2..P5 of 640x1024": (
            lambda: roi_op(args), lambda: ROI_ALIGN_KERNEL(*args)),
    }
    out = {}
    for name, (op, wrapper) in pairs.items():
        a, b, c, d = host_us(op), host_us(wrapper), host_us(wrapper), host_us(op)
        out[name] = dict(op_us=(a + d) / 2, wrapper_us=(b + c) / 2, op_runs=[a, d],
                         wrapper_runs=[b, c])
        print(f"host time of one call, {name}: operator {a:.1f} / {d:.1f} us, ctypes wrapper "
              f"{b:.1f} / {c:.1f} us (op, wrapper, wrapper, op; {HOST_CALLS} calls each)  "
              f"({card})")
    return out


def serve_artifact(name, export_dir, det, cfg, requests, card, expected):
    """The requests through `load_predict(export_dir)` against the
    detector's direct `predict`: labels and validity equal, boxes within
    EXPORT_BOX_TOL px, scores within EXPORT_SCORE_TOL. Checks the kernel
    launches of the artifact's run alone (`expected`) and returns them."""
    t0 = time.perf_counter()
    predict, meta = load_predict(export_dir)
    load_s = time.perf_counter() - t0
    require(meta["platforms"] == ["cuda"], f"{name}: exported for {meta['platforms']}")
    items = [preprocess_eval_image(img, cfg)[:2] for img in requests]
    want = [[t.cpu() for t in det.predict(p, hw)] for p, hw in items]
    predict(*items[0])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    reset_launches()
    got = [predict(p, hw) for p, hw in items]
    torch.cuda.synchronize()
    launches = launch_counts()
    box_err = score_err = 0.0
    for (gb, gl, gs, gv), (wb, wl, ws, wv) in zip(([t.cpu() for t in g] for g in got), want):
        require(torch.equal(gv, wv) and torch.equal(gl, wl),
                f"{name}: labels or validity differ from the direct predict")
        box_err = max(box_err, float((gb - wb).abs().max()))
        score_err = max(score_err, float((gs - ws).abs().max()))
    require(box_err <= EXPORT_BOX_TOL and score_err <= EXPORT_SCORE_TOL,
            f"{name}: box err {box_err} px, score err {score_err} against the direct predict")
    n = sum(int(w[3].sum()) for w in want)
    print(f"{name}: {len(items)} requests through the reloaded artifact ({load_s:.2f} s to "
          f"load), {n} detections, labels and validity equal to the direct predict, max box "
          f"diff {box_err:.3g} px, max score diff {score_err:.3g}; launches {launches}  "
          f"({card})")
    want_launches = dict.fromkeys(KERNELS, 0)
    want_launches.update(expected)
    require(launches == want_launches, f"{name} launches {launches} != {want_launches}")
    p, hw = items[0]
    art_ms = cuda_ms(lambda: predict(p, hw), iters=5)
    direct_ms = cuda_ms(lambda: det.predict(p, hw), iters=5)
    print(f"{name} one request {p.shape[0]}x{p.shape[1]}: artifact {art_ms:.2f} ms, direct "
          f"predict {direct_ms:.2f} ms  ({card})")
    return launches


def export_with_times(det, out_dir, bake_params):
    """`export_predict` -> (seconds of each artifact, by file name, from the
    files' modification times, and their sizes in bytes)."""
    t0 = time.time()
    export_predict(det, str(out_dir), bake_params=bake_params)
    stamps = sorted((os.path.getmtime(f), f.name) for f in out_dir.glob("predict_*.pt2"))
    seconds, last = {}, t0
    for stamp, name in stamps:
        seconds[name], last = stamp - last, stamp
    sizes = {f.name: f.stat().st_size for f in out_dir.iterdir()}
    return seconds, sizes


def drive_export(requests, card):
    """The serving export: C4 ResNet-50 float32 (TF32 off) exported with its
    weights baked for both buckets, FPN ResNet-50 float32 exported program
    only (`bake_params=False`, the 640x1024 bucket and its portrait twin,
    so that the 8 requests are served), both reloaded with `load_predict`
    and held against the detector's direct `predict`; K1 launches through
    both programs and K4 through FPN's. Then the host time of one operator
    call against its ctypes wrapper."""
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, model_type, baked, expected in (
                ("export_frcnn_baked", "faster_rcnn", True,
                 {"nms_alive_sorted": 2 * len(requests)}),
                ("export_fpn_program_only", "fpn", False,
                 {"nms_alive_sorted": 2 * len(requests), "roi_align_multilevel": len(requests)})):
            cfg = dict(config_factory("pascal", model_type))
            det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
            out = Path(tmp) / name
            seconds, sizes = export_with_times(det, out, baked)
            state_mb = sum(t.numel() * t.element_size() for t in det.state_dict().values()) / 2**20
            print(f"{name}: exported {', '.join(f'{k} in {v:.2f} s' for k, v in seconds.items())}"
                  f"; files {', '.join(f'{k} {v / 2**20:.3f} MiB' for k, v in sizes.items())} "
                  f"(weights {state_mb:.3f} MiB)  ({card})")
            paths[name] = serve_artifact(name, out, det, cfg, requests, card, expected)
            del det
            torch.cuda.empty_cache()
    op_host_times(card)
    return paths


# ----------------------------------------------------------- data parallelism
DP_TIMEOUT_S = 300.0  # a collective, and the parent's wait for its ranks
DP_TIMED_STEPS = 4
DP_WORLD = 2
DP_ITEMS = (0, 2)  # two landscape requests: one 640x1024 bucket
DP_PLAIN_RUNS = 3
DP_SPREAD_FACTOR = 3.0
EVAL_BOX_TOL, EVAL_SCORE_TOL = 1e-4, 1e-5  # px; eval DP against one device


def params_on_host(det) -> dict:
    return {n: p.detach().cpu().clone() for n, p in det.named_parameters()}


def largest_rel_diff(a: dict, b: dict) -> tuple[float, str]:
    """(largest |a - b| / max|b| over the tensors, its tensor)."""
    return max((float((a[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30), n)
               for n, w in b.items())


def fpn_ddp_world1(card) -> dict:
    """`Trainer(data_parallel=True)` over an NCCL group of one process, 2
    steps at full width (FPN ResNet-50, stock Pascal config, the trainer
    phase's learning rate), against plain `Trainer`s on the same batches
    and draws. K5 adds in no fixed order, so plain runs differ too: the DP
    run's updates must differ from the nearest plain run's, in norm over
    all parameters, by no more than DP_SPREAD_FACTOR times the largest
    difference among DP_PLAIN_RUNS plain runs (a tensor's largest
    difference prints too: it follows a few near-zero biases and varies
    3x between calls). Launches per step as phase 7's."""
    cfg = trainer_config("fpn")
    rng = np.random.RandomState(0)
    items = make_train_items()
    batches = []
    for i in range(2):
        images, hw, boxes, mask, labels = train_batch([items[i]], cfg, rng)
        batches.append({"images": images.cpu().numpy(), "image_hw": hw.cpu().numpy(),
                        "gt_boxes": boxes.cpu().numpy(), "gt_mask": mask.cpu().numpy(),
                        "gt_labels": labels.cpu().numpy()})
    probe = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
    start = params_on_host(probe)  # a Trainer re-initializes from the same seed
    gen = torch.Generator(device="cuda").manual_seed(21)
    draws = {s + 1: probe.sample_draws(gen, 1, b["images"].shape[1:3])
             for s, b in enumerate(batches)}
    del probe

    def update_gap(a, b):
        """|a - b| / |b - start| over all parameters: how far two runs'
        updates differ, relative to the update's size."""
        num = sum(float((a[n] - w).double().square().sum()) for n, w in b.items())
        den = sum(float((w - start[n]).double().square().sum()) for n, w in b.items())
        return (num / max(den, 1e-300)) ** 0.5

    def run(parallel):
        det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(det, tmp, logging_every_n_steps=1000, summary_every_n_steps=1000,
                              saving_every_n_steps=1000, seed=0, draws=draws.get,
                              data_parallel=parallel)
            reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.train_one_epoch(iter(batches), steps=len(batches))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / len(batches)
            launches = launch_counts()
            trainer.close()
        out = params_on_host(det)
        del trainer, det
        torch.cuda.empty_cache()
        return out, launches, ms

    backend = "nccl"
    rank, world = multihost.initialize(device="cuda", backend=backend, timeout_s=DP_TIMEOUT_S)
    require((rank, world) == (0, 1), f"world-1 group: rank {rank}, world {world}")
    try:
        dp, launches, dp_ms = run(True)
    finally:
        multihost.shutdown()
    plains = [run(False) for _ in range(DP_PLAIN_RUNS)]
    expected = {k: PER_STEP["fpn"].get(k, 0) * len(batches) for k in KERNELS}
    require(launches == expected, f"fpn_ddp_nccl_w1 launches {launches} != {expected}")
    pairs = [(a[0], b[0]) for i, a in enumerate(plains) for b in plains[i + 1:]]
    spread = max(update_gap(a, b) for a, b in pairs)
    gap = min(update_gap(dp, p[0]) for p in plains)
    tensor_spread = max(largest_rel_diff(a, b) for a, b in pairs)
    tensor_gap = min(largest_rel_diff(dp, p[0]) for p in plains)
    print(f"fpn_ddp_nccl_w1: Trainer(data_parallel=True) over {backend} at world size 1, "
          f"{len(batches)} steps of batch 1 at full width: its updates differ from the nearest "
          f"plain Trainer's by {gap:.3g} of their norm ({tensor_gap[0]:.3g} of a tensor's "
          f"largest value at most, {tensor_gap[1]}); {DP_PLAIN_RUNS} plain runs differ among "
          f"themselves by up to {spread:.3g} ({tensor_spread[0]:.3g}, {tensor_spread[1]}; K5 "
          f"adds in no fixed order); step {dp_ms:.2f} ms against plain {plains[0][2]:.2f} ms; "
          f"launches {launches}  ({card})")
    require(gap <= DP_SPREAD_FACTOR * spread,
            f"fpn_ddp_nccl_w1: the updates differ by {gap:.3g} of their norm, more than "
            f"{DP_SPREAD_FACTOR} x the plain runs' {spread:.3g}")
    return {"fpn_ddp_nccl_w1": launches}


def dp_rank(spec_path: str, rank: int) -> int:
    """One rank of `fpn_dp2_train` (run as `chip_smoke.py --dp-rank R SPEC`):
    joins the group of the spec, steps once on its rows of the global batch
    with the global draws (launches counted), writes its parameters, then
    times DP_TIMED_STEPS more steps, as many without the gradient
    all-reduce (DDP's `no_sync`: the ranks' parameters part), and one
    all-reduce of the gradient bytes alone."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = multihost.local_device(spec["devices"][rank])
    multihost.initialize(init_method=spec["init_method"], num_processes=DP_WORLD,
                         process_id=rank, backend=spec["backend"], device=device,
                         timeout_s=DP_TIMEOUT_S)
    try:
        cfg = dict(config_factory("pascal", "fpn"))
        det = model_factory("fpn", "resnet50", cfg, device=device, seed=0)
        det.load_state_dict(torch.load(spec["state"], weights_only=True))
        opt = make_optimizer(cfg, det)
        step = make_parallel_train_step(det, opt)
        inputs = torch.load(spec["inputs"], weights_only=True)
        lo, hi = multihost.local_batch_slice(inputs["batch"][0].shape[0], rank, DP_WORLD)
        batch = tuple(t[lo:hi].to(device) for t in inputs["batch"])
        draws = TrainDraws(*inputs["draws"]).to(device)
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(batch, draws)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = launch_counts()
        torch.save(params_on_host(det), Path(spec["out"]) / f"params{rank}.pt")
        times = {}
        for sync in (True, False):  # then without the gradient all-reduce (DDP's no_sync)
            times[sync] = []
            for _ in range(DP_TIMED_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with contextlib.nullcontext() if sync else step.ddp.no_sync():
                    step(batch, draws)
                torch.cuda.synchronize()
                times[sync].append((time.perf_counter() - t) * 1e3)
        n = sum(p.numel() for p in det.parameters() if p.requires_grad)
        grads = torch.zeros(n, device=device)
        reduce_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.distributed.all_reduce(grads)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t) * 1e3)
        report = {"rank": rank, "device": str(device), "launches": launches,
                  "metrics": {k: float(v) for k, v in metrics.items()}, "first_ms": first_ms,
                  "step_ms": float(np.median(times[True])),
                  "no_sync_ms": float(np.median(times[False])),
                  "allreduce_ms": float(np.median(reduce_ms)), "grad_bytes": 4 * n}
        with open(Path(spec["out"]) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        multihost.shutdown()
    return 0


def run_ranks(spec: dict, tmp: Path, flag: str = "--dp-rank", what: str = "fpn_dp2_train") -> list:
    """DP_WORLD ranks of this script with `flag` (`dp_rank`, `sp_rank`) at
    once; kills every rank left after DP_TIMEOUT_S and raises with the
    ranks' output if any failed."""
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(DP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(spec_path)], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{what} ranks failed: " + " ".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{out[-3000:]}"
            for r, (p, out) in enumerate(zip(procs, outputs))))
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]


def hold_updates(name, against, before, after, got, moved_after) -> dict:
    """Hold the updates of a parallel step (`got`, parameters after it)
    against a reference step's (`after`) from the same `before`: each
    trainable tensor's within GRAD_TOL of its largest value, or, where the
    reference step with the input x (1 + INPUT_MOVE) (`moved_after`, phase
    7's conditioning) moves it by more, within twice that move; all of them
    within GRAD_TOL of their norm, or twice the move of the norm."""
    trainable = [n for n in after if not torch.equal(after[n], before[n])]
    worst, move_worst, by_move = (0.0, ""), (0.0, ""), 0
    sq = {"gap": 0.0, "move": 0.0, "update": 0.0}
    for n in trainable:
        upd = after[n] - before[n]
        scale = max(float(upd.abs().max()), 1e-30)
        diff, moved = got[n] - before[n] - upd, moved_after[n] - after[n]
        gap = float(diff.abs().max()) / scale
        move = float(moved.abs().max()) / scale
        bound = GRAD_TOL if move <= GRAD_TOL else 2.0 * move
        by_move += move > GRAD_TOL
        require(gap <= bound, f"{name}: update of {n} differs by {gap:.3g} of its largest "
                f"value from {against} (bound {bound:.3g}; the input x (1 + "
                f"{INPUT_MOVE:g}) moves it by {move:.3g})")
        worst, move_worst = max(worst, (gap, n)), max(move_worst, (move, n))
        for key, t in (("gap", diff), ("move", moved), ("update", upd)):
            sq[key] += float(t.double().square().sum())
    gap_all, move_all = ((sq[k] / sq["update"]) ** 0.5 for k in ("gap", "move"))
    bound_all = GRAD_TOL if move_all <= GRAD_TOL else 2.0 * move_all
    require(gap_all <= bound_all, f"{name}: the updates differ by {gap_all:.3g} of their "
            f"norm from {against} (bound {bound_all:.3g}; the input moves them by "
            f"{move_all:.3g})")
    return {"trainable": trainable, "gap_all": gap_all, "worst": worst, "by_move": by_move,
            "move_all": move_all, "move_worst": move_worst}


def fpn_dp2_train(card) -> dict:
    """Two processes, b = 1 each, at full width (FPN ResNet-50, stock Pascal
    config, float32, frozen BatchNorms calibrated to the batch), against
    one process at B = 2 from the same weights, batch and global draws:
    losses within rtol 1e-4 and counts equal, the updates within GRAD_TOL
    of their norm and each trainable tensor's within GRAD_TOL of its
    largest value (where a 1e-6 change of the input alone moves an update
    by more, within twice that move; the move, phase 7's conditioning,
    prints), the ranks' parameters bit-equal, K1, K4 and K5 launched once
    on each rank. The RPN score layer is scaled by 20 so that random-weight
    proposals separate, as in phase 7's checks. Gloo over CUDA tensors where the
    machine has one GPU (NCCL refuses two ranks on one device), NCCL over
    two GPUs where it has them."""
    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    devices = ["cuda:0", "cuda:1"] if two else ["cuda:0", "cuda:0"]
    cfg = dict(config_factory("pascal", "fpn"))
    items = make_train_items()
    batch = train_batch([items[i] for i in DP_ITEMS], cfg, np.random.RandomState(0))
    det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
    calibrate_frozen_bn(det, lambda: det.extractor(batch[0]))
    with torch.no_grad():  # random-weight proposals separate, as in phase 7's checks
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
    state = {k: v.cpu() for k, v in det.state_dict().items()}
    draws = det.sample_draws(torch.Generator(device="cuda").manual_seed(7), DP_WORLD,
                             batch[0].shape[1:3])
    before = params_on_host(det)
    del det
    torch.cuda.empty_cache()

    def single(inputs):
        det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
        det.load_state_dict(state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = make_train_step(det, make_optimizer(cfg, det))(inputs, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = params_on_host(det)
        del det
        torch.cuda.empty_cache()
        return {k: float(v) for k, v in metrics.items()}, after, ms

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save(state, tmp / "state.pt")
        torch.save({"batch": tuple(t.cpu() for t in batch),
                    "draws": tuple(None if t is None else t.cpu() for t in draws)},
                   tmp / "inputs.pt")
        spec = {"backend": backend, "devices": devices, "init_method": f"file://{tmp / 'store'}",
                "state": str(tmp / "state.pt"), "inputs": str(tmp / "inputs.pt"), "out": str(tmp)}
        print(f"fpn_dp2_train: {DP_WORLD} ranks over {backend} on {devices} "
              f"(torch.cuda.device_count() = {torch.cuda.device_count()})")
        reports = run_ranks(spec, tmp)
        ranks = [torch.load(tmp / f"params{r}.pt", weights_only=True) for r in range(DP_WORLD)]
    want, after, single_ms = single(batch)
    _, moved_after, _ = single((batch[0] * (1.0 + INPUT_MOVE), *batch[1:]))
    require(all(torch.equal(ranks[0][n], ranks[1][n]) for n in ranks[0]),
            "fpn_dp2_train: the ranks' parameters differ")
    for k, v in want.items():
        got = sum(r["metrics"][k] for r in reports) / DP_WORLD
        tol = 1e-4 * abs(v) if k.endswith("loss") else 0.0
        require(abs(got - v) <= tol, f"fpn_dp2_train {k}: ranks' mean {got} vs B=2 {v}")
    held = hold_updates("fpn_dp2_train", "the B=2 step's", before, after, ranks[0], moved_after)
    trainable, gap_all, worst, by_move, move_all, move_worst = (
        held[k] for k in ("trainable", "gap_all", "worst", "by_move", "move_all", "move_worst"))
    per_step = PER_STEP["fpn"]
    for r in reports:
        expected = {k: per_step.get(k, 0) for k in KERNELS}
        require(r["launches"] == expected,
                f"fpn_dp2_train rank {r['rank']} launches {r['launches']} != {expected}")
    print(f"fpn_dp2_train: losses of the ranks' mean within rtol 1e-4 of one process at B=2 "
          f"(total {sum(r['metrics']['total_loss'] for r in reports) / DP_WORLD:.6f} vs "
          f"{want['total_loss']:.6f}), counts equal; all {len(trainable)} updates within "
          f"{gap_all:.3g} of their norm, each within {worst[0]:.3g} of its largest value "
          f"({worst[1]}; tolerance {GRAD_TOL}, {by_move} tensors bounded by twice their move "
          f"instead); the input x (1 + {INPUT_MOVE:g}) moves the B=2 step's updates by "
          f"{move_all:.3g} of their norm, each by up to {move_worst[0]:.3g} "
          f"({move_worst[1]}); ranks' parameters bit-equal  ({card})")
    for r in reports:
        share = 1.0 - r["no_sync_ms"] / r["step_ms"]
        print(f"fpn_dp2_train rank {r['rank']} on {r['device']}: launches {r['launches']}; "
              f"first step {r['first_ms']:.2f} ms, then median {r['step_ms']:.2f} ms a step, "
              f"{r['no_sync_ms']:.2f} ms without the gradient all-reduce (no_sync): the "
              f"all-reduce of the {r['grad_bytes'] / 2**20:.1f} MiB of trainable gradients over "
              f"{backend} takes {share:.3f} of the step; one all_reduce of them alone "
              f"{r['allreduce_ms']:.2f} ms; one process at B=2: {single_ms:.2f} ms (its first "
              f"step)  ({card})")
    return {f"fpn_dp2_train_rank{r['rank']}": r["launches"] for r in reports}


def eval_dp2(model_type, requests, card) -> dict:
    """Batched eval over two replicas on cuda:0 (`devices=[cuda:0, cuda:0]`,
    `data_parallel=2`, batch 4: a shard of 2 a replica) against one device
    at batch 2, the shards' shapes (cuDNN picks its algorithms by shape, and
    a last-bit difference reorders near-equal random-weight proposals), on
    the 8 requests: per image and class, validity equal, boxes within
    EVAL_BOX_TOL px and scores within EVAL_SCORE_TOL; through
    `get_prediction_files` with the same replicas, K1 once a
    shard and once an image, FPN's K4 once a shard; the current CUDA device
    unchanged. The frozen BatchNorms are set to the statistics of a batch
    of the requests, and the RPN and RoI score layers scaled as phase 6's
    CPU checks scale them, so that random-weight proposals and class scores
    separate (else near-equal scores may come out of the class NMS in
    another order). Times a `get_prediction_files` of each."""
    name = f"{PATH_NAME[model_type]}_eval_dp2"
    cfg = dict(config_factory("pascal", model_type))
    det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
    devices = [torch.device("cuda", 0)] * 2
    items = [preprocess_eval_image(img, cfg) for img in requests]
    landscape = [it for it in items if it[0].shape[0] < it[0].shape[1]][:BATCH]
    calibrate_frozen_bn(det, lambda: det.im_detect_batch(
        *(np.stack([it[k] for it in landscape]) for k in range(3))))
    rpn_scale, roi_scale = CPU_CHECKS[model_type][3:]
    with torch.no_grad():  # proposals and class scores of random weights separate
        det.rpn_head.rpn_score_conv.weight.mul_(rpn_scale)
        det.roi_head.roi_head_score.weight.mul_(roi_scale)
    current = torch.cuda.current_device()

    def detections(batch_size, dp):
        out = {}
        for idx, item, raw in batched_im_detect(det, items, batch_size, dp,
                                                devices if dp else None):
            dets = eval_post_process(
                *raw, float(item[3]), float(item[4]),
                max_per_class=cfg["max_objects_per_class_per_image"],
                score_threshold=cfg["prediction_score_threshold"],
                nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
                target_means=tuple(cfg["roi_proposal_means"]),
                target_stds=tuple(cfg["roi_proposal_stds"]))
            out[idx] = tuple(t.cpu() for t in dets)
        return out

    one, two = detections(BATCH // 2, 0), detections(BATCH, 2)
    box_err = score_err = 0.0
    n = 0
    for idx, (b, s, v) in one.items():
        b2, s2, v2 = two[idx]
        require(torch.equal(v, v2), f"{name}: image {idx}: validity differs from one device")
        box_err = max(box_err, float((b[v] - b2[v]).abs().max()) if v.any() else 0.0)
        score_err = max(score_err, float((s[v] - s2[v]).abs().max()) if v.any() else 0.0)
        n += int(v.sum())
    require(n > 0, f"{name}: no detection")
    require(box_err <= EVAL_BOX_TOL and score_err <= EVAL_SCORE_TOL,
            f"{name}: box err {box_err} px, score err {score_err} against one device")
    shards = 2 * sum(-(-sum(tuple(it[0].shape[:2]) == b for it in items) // BATCH)
                     for b in {tuple(it[0].shape[:2]) for it in items})
    ids = [f"{i:06d}" for i in range(len(items))]
    torch.cuda.synchronize()
    t = time.perf_counter()
    replicate(det, devices)
    torch.cuda.synchronize()
    replicate_ms = (time.perf_counter() - t) * 1e3
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dp in (0, 2):
            fmt = str(Path(tmp) / f"dp{dp}_{{}}.txt")
            kwargs = dict(batch_size=BATCH, data_parallel=dp, devices=devices if dp else None)
            get_prediction_files(det, iter(items), ids, fmt, **kwargs)  # warm-up
            reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            get_prediction_files(det, iter(items), ids, fmt, **kwargs)
            torch.cuda.synchronize()
            times[dp] = (time.perf_counter() - t) * 1e3
            launches = launch_counts()
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = shards + len(items)
    if model_type == "fpn":
        expected["roi_align_multilevel"] = shards
    require(launches == expected, f"{name} launches {launches} != {expected}")
    require(torch.cuda.current_device() == current,
            f"{name}: the current CUDA device moved from {current} to "
            f"{torch.cuda.current_device()}")
    print(f"{name}: 2 replicas on {[str(d) for d in devices]} at batch {BATCH} against one "
          f"device at batch {BATCH // 2}, {len(items)} requests: {n} detections, validity "
          f"equal, max box diff {box_err:.3g} px, max score diff {score_err:.3g}; "
          f"get_prediction_files launches {launches} ({shards} shards), {times[2]:.1f} ms "
          f"(of which making the second replica {replicate_ms:.1f} ms) against {times[0]:.1f} "
          f"ms on one device at batch {BATCH}; current device {current} unchanged  ({card})")
    del det
    torch.cuda.empty_cache()
    return {name: launches}


def drive_data_parallel(requests, card) -> dict:
    paths = fpn_ddp_world1(card)
    paths.update(fpn_dp2_train(card))
    for model_type in ("faster_rcnn", "fpn"):
        paths.update(eval_dp2(model_type, requests, card))
    return paths

# ----------------------------------------------------- spatial partitioning
SP_TIMED_STEPS = 3
SP_EXCHANGE_REPLAYS = 3
# the gathered stride-16 map against the unsharded extractor's, relative to
# its largest value: cuDNN picks its algorithms by shape, and a shard's rows
# are another shape than the whole map's (measured 2.06e-5)
SP_MAP_TOL = 1e-4
# spatial predict against the detector's own, (rtol, atol): scores as JAX's
# tests/test_spatial.py; boxes within 0.05 px, not JAX's 1e-3: the gathered
# map's 2e-5 (cuDNN's algorithms by shape) moves a box by up to 0.016 px
# (measured), and phase 12's replicas hold 1e-4 px only on equal shapes
SP_BOX_TOL, SP_SCORE_TOL = (1e-4, 0.05), (1e-4, 1e-5)


def exchange_ms(traffic, groups, device) -> float:
    """The collectives of a step's `traffic` ((kind, collective, output
    bytes) in order) replayed alone on float32 buffers of their sizes over
    the space group: the median ms of SP_EXCHANGE_REPLAYS replays."""
    calls = []
    for _, collective, nbytes in traffic:
        if collective == "all_gather":
            part = torch.zeros(nbytes // 4 // groups.sp, device=device)
            calls.append((part, [torch.empty_like(part) for _ in range(groups.sp)]))
        else:
            calls.append((torch.zeros(nbytes // 4, device=device), None))
    times = []
    for _ in range(SP_EXCHANGE_REPLAYS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x, parts in calls:
            if parts is None:
                torch.distributed.all_reduce(x, group=groups.space)
            else:
                torch.distributed.all_gather(parts, x, group=groups.space)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def traffic_bytes(traffic) -> dict:
    return {kind: sum(n for k, _, n in traffic if k == kind) for kind in ("halo", "gather")}


def sp_train_case(case, groups, device, out: Path, rank: int) -> dict:
    """One spatial step on the global batch of the case (CPU tensors: the
    step moves only this rank's rows to the card) with its draws, launches
    counted and the exchanges recorded; writes the parameters after it;
    then SP_TIMED_STEPS more steps timed, and the exchanges replayed."""
    cfg = dict(config_factory("pascal", case["model_type"]))
    det = model_factory(case["model_type"], "resnet50", cfg, device=device, seed=0)
    det.load_state_dict(torch.load(case["state"], weights_only=True))
    step = make_spatial_train_step(det, make_optimizer(cfg, det), groups)
    inputs = torch.load(case["inputs"], weights_only=True)
    batch = tuple(inputs["batch"])
    draws = TrainDraws(*inputs["draws"]).to(device)
    reset_launches()
    groups.traffic = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    metrics = step(batch, draws)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()
    traffic, groups.traffic = groups.traffic, None
    torch.save(params_on_host(det), out / f"{case['name']}_params{rank}.pt")
    times = []
    for _ in range(SP_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch, draws)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {"launches": launches, "metrics": {k: float(v) for k, v in metrics.items()},
            "first_ms": first_ms, "step_ms": float(np.median(times)),
            "bytes": traffic_bytes(traffic), "exchanges": len(traffic),
            "exchange_ms": exchange_ms(traffic, groups, device)}


def sp_predict_case(case, groups, device, out: Path, rank: int) -> dict:
    """One request through the spatial `predict` (launches counted) against
    the detector's own `predict` on this rank, and the gathered stride-16
    map against the unsharded extractor's."""
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    det = model_factory("faster_rcnn", "resnet50", cfg, device=device, seed=0)
    det.load_state_dict(torch.load(case["state"], weights_only=True))
    inputs = torch.load(case["inputs"], weights_only=True)
    image, hw = inputs["image"].numpy(), inputs["image_hw"].numpy()
    predict = make_spatial_predict(det, groups)
    height = image.shape[0]
    shard = RowShard(groups, height, det.extractor_levels)
    lo, hi = shard.owned(height)
    with torch.inference_mode():
        with sharded_extractor(det, shard):
            gathered = det._extract(torch.as_tensor(image[lo:hi][None], device=device))
        whole = det.extractor(torch.as_tensor(image[None], device=device))
    map_err = float((gathered - whole).abs().max()) / float(whole.abs().max())
    predict(image, hw)  # warm-up
    reset_launches()
    groups.traffic = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = predict(image, hw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()
    traffic, groups.traffic = groups.traffic, None
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = det.predict(image, hw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    v = want.valid
    return {"launches": launches, "map_err": map_err, "ms": ms, "plain_ms": plain_ms,
            "valid_equal": bool(torch.equal(got.valid, v)), "n": int(v.sum()),
            "labels_equal": bool(torch.equal(got.labels[v], want.labels[v])),
            "box_err": float((got.boxes[v] - want.boxes[v]).abs().max()) if v.any() else 0.0,
            "score_err": float((got.scores[v] - want.scores[v]).abs().max()) if v.any() else 0.0,
            "box_ok": bool(torch.allclose(got.boxes[v], want.boxes[v], *SP_BOX_TOL)),
            "score_ok": bool(torch.allclose(got.scores[v], want.scores[v], *SP_SCORE_TOL)),
            "bytes": traffic_bytes(traffic), "exchanges": len(traffic),
            "exchange_ms": exchange_ms(traffic, groups, device)}


SP_CASES = {"train": sp_train_case, "predict": sp_predict_case}


def sp_rank(spec_path: str, rank: int) -> int:
    """One rank of phase 13 (run as `chip_smoke.py --sp-rank R SPEC`): joins
    the group of the spec, builds its space group of DP_WORLD ranks and
    runs the spec's cases in order; writes its report."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = multihost.local_device(spec["devices"][rank])
    multihost.initialize(init_method=spec["init_method"], num_processes=DP_WORLD,
                         process_id=rank, backend=spec["backend"], device=device,
                         timeout_s=DP_TIMEOUT_S)
    try:
        groups = make_spatial_groups(DP_WORLD, timeout_s=DP_TIMEOUT_S)
        report = {"rank": rank, "device": str(device)}
        for case in spec["cases"]:
            report[case["name"]] = SP_CASES[case["kind"]](case, groups, device,
                                                          Path(spec["out"]), rank)
        with open(Path(spec["out"]) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        multihost.shutdown()
    return 0


def sp_train_inputs(model_type, tmp: Path, name: str):
    """The state (frozen BatchNorms calibrated to the batch, the RPN score
    layer x20, as phase 12), one landscape training image and its draws of
    a spatial training case, written for the ranks -> (case, reference)."""
    cfg = dict(config_factory("pascal", model_type))
    batch = train_batch([make_train_items()[DP_ITEMS[0]]], cfg, np.random.RandomState(0))
    det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
    calibrate_frozen_bn(det, lambda: det.extractor(batch[0]))
    with torch.no_grad():  # random-weight proposals separate, as in phase 7's checks
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
    state = {k: v.cpu() for k, v in det.state_dict().items()}
    draws = det.sample_draws(torch.Generator(device="cuda").manual_seed(7), 1,
                             batch[0].shape[1:3])
    before = params_on_host(det)
    del det
    torch.save(state, tmp / f"{name}_state.pt")
    torch.save({"batch": tuple(t.cpu() for t in batch),
                "draws": tuple(None if t is None else t.cpu() for t in draws)},
               tmp / f"{name}_inputs.pt")
    case = {"name": name, "kind": "train", "model_type": model_type,
            "state": str(tmp / f"{name}_state.pt"), "inputs": str(tmp / f"{name}_inputs.pt")}
    return case, (model_type, cfg, state, batch, draws, before)


def sp_predict_inputs(requests, tmp: Path):
    """C4 with its frozen BatchNorms set to the statistics of a batch of the
    requests and its RPN and RoI score layers scaled as phase 6's CPU checks
    scale them (random-weight proposals and class scores separate, as in
    phase 12's eval checks), and the first landscape request, padded."""
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=0)
    items = [preprocess_eval_image(img, cfg) for img in requests]
    landscape = [it for it in items if it[0].shape[0] < it[0].shape[1]][:BATCH]
    calibrate_frozen_bn(det, lambda: det.im_detect_batch(
        *(np.stack([it[k] for it in landscape]) for k in range(3))))
    rpn_scale, roi_scale = CPU_CHECKS["faster_rcnn"][3:]
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(rpn_scale)
        det.roi_head.roi_head_score.weight.mul_(roi_scale)
    torch.save({k: v.cpu() for k, v in det.state_dict().items()}, tmp / "predict_state.pt")
    torch.save({"image": torch.as_tensor(landscape[0][0]),
                "image_hw": torch.as_tensor(np.asarray(landscape[0][1]))},
               tmp / "predict_inputs.pt")
    del det
    return {"name": "frcnn_sp2_predict", "kind": "predict",
            "state": str(tmp / "predict_state.pt"), "inputs": str(tmp / "predict_inputs.pt")}


def drive_spatial(requests, card) -> dict:
    """Phase 13: `frcnn_sp2_train`, `fpn_sp2_train` and `frcnn_sp2_predict`
    on two processes of this script (`--sp-rank R SPEC`, started with a
    deadline, killed at it), each image's rows sharded over them, against
    one process on the same weights and draws."""
    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    devices = ["cuda:0", "cuda:1"] if two else ["cuda:0", "cuda:0"]
    refs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cases = []
        for model_type in ("faster_rcnn", "fpn"):
            name = f"{PATH_NAME[model_type]}_sp2_train"
            case, refs[name] = sp_train_inputs(model_type, tmp, name)
            cases.append(case)
        cases.append(sp_predict_inputs(requests, tmp))
        torch.cuda.empty_cache()
        spec = {"backend": backend, "devices": devices, "init_method": f"file://{tmp / 'store'}",
                "out": str(tmp), "cases": cases}
        print(f"spatial partitioning: {DP_WORLD} ranks over {backend} on {devices}, each "
              f"image's rows sharded over them (torch.cuda.device_count() = "
              f"{torch.cuda.device_count()})")
        reports = run_ranks(spec, tmp, "--sp-rank", "spatial")
        rank_params = {name: [torch.load(tmp / f"{name}_params{r}.pt", weights_only=True)
                              for r in range(DP_WORLD)] for name in refs}
    paths = {}
    for name, (model_type, cfg, state, batch, draws, before) in refs.items():
        def single(images):
            det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
            det.load_state_dict(state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = make_train_step(det, make_optimizer(cfg, det))((images, *batch[1:]), draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            after = params_on_host(det)
            del det
            torch.cuda.empty_cache()
            return {k: float(v) for k, v in metrics.items()}, after, ms

        want, after, _ = single(batch[0])
        moved, moved_after, single_ms = single(batch[0] * (1.0 + INPUT_MOVE))
        ranks = rank_params[name]
        require(all(torch.equal(ranks[0][n], ranks[1][n]) for n in ranks[0]),
                f"{name}: the ranks' parameters differ")
        loss_gaps = {}
        for r in reports:
            got = r[name]["metrics"]
            for k, v in want.items():
                if not k.endswith("loss"):
                    require(got[k] == v, f"{name} rank {r['rank']} {k}: {got[k]} vs {v}")
                    continue
                gap, move = abs(got[k] - v) / abs(v), abs(moved[k] - v) / abs(v)
                bound = 1e-4 if move <= 1e-4 else 2.0 * move
                require(gap <= bound, f"{name} rank {r['rank']} {k}: {got[k]} vs one process "
                        f"{v} (relative gap {gap:.3g}, bound {bound:.3g}; the input x (1 + "
                        f"{INPUT_MOVE:g}) moves it by {move:.3g})")
                loss_gaps[k] = max(loss_gaps.get(k, (0.0, 0.0)), (gap, move))
        held = hold_updates(name, "one process's", before, after, ranks[0], moved_after)
        expected = {k: PER_STEP[model_type].get(k, 0) for k in KERNELS}
        for r in reports:
            require(r[name]["launches"] == expected,
                    f"{name} rank {r['rank']} launches {r[name]['launches']} != {expected}")
            paths[f"{name}_rank{r['rank']}"] = r[name]["launches"]
        print(f"{name}: {DP_WORLD} ranks, B=1 at full width, each image's rows sharded: losses "
              f"against one process, relative gap (the input move's): " + ", ".join(
                  f"{k} {g:.3g} ({m:.3g})" for k, (g, m) in loss_gaps.items())
              + f" (rtol 1e-4, or twice the move above it); counts equal; all "
              f"{len(held['trainable'])} updates "
              f"within {held['gap_all']:.3g} of their norm, each within {held['worst'][0]:.3g} of "
              f"its largest value ({held['worst'][1]}; tolerance {GRAD_TOL}, {held['by_move']} "
              f"tensors bounded by twice their move instead); the input x (1 + {INPUT_MOVE:g}) "
              f"moves one process's updates by {held['move_all']:.3g} of their norm, each by up "
              f"to {held['move_worst'][0]:.3g} ({held['move_worst'][1]}); ranks' parameters "
              f"bit-equal  ({card})")
        for r in reports:
            c = r[name]
            print(f"{name} rank {r['rank']} on {r['device']}: launches {c['launches']}; first "
                  f"step {c['first_ms']:.2f} ms, then median {c['step_ms']:.2f} ms a step; "
                  f"{c['exchanges']} exchanges a step move {c['bytes']['halo'] / 2**20:.2f} MiB "
                  f"of halos and {c['bytes']['gather'] / 2**20:.2f} MiB of gathered maps "
                  f"(collective outputs on this rank, forward and backward) in "
                  f"{c['exchange_ms']:.2f} ms replayed alone; one process: {single_ms:.2f} ms "
                  f"(its second step on a fresh detector)  ({card})")
    name = "frcnn_sp2_predict"
    for r in reports:
        c = r[name]
        require(c["map_err"] <= SP_MAP_TOL, f"{name} rank {r['rank']}: the gathered map differs "
                f"by {c['map_err']:.3g} of its largest value from the unsharded extractor's")
        require(c["valid_equal"] and c["labels_equal"] and c["n"] > 0,
                f"{name} rank {r['rank']}: validity or labels differ from predict ({c['n']} "
                "detections)")
        require(c["box_ok"] and c["score_ok"], f"{name} rank {r['rank']}: box err "
                f"{c['box_err']} px, score err {c['score_err']} against predict")
        expected = dict.fromkeys(KERNELS, 0)
        expected["nms_alive_sorted"] = 2
        require(c["launches"] == expected,
                f"{name} rank {r['rank']} launches {c['launches']} != {expected}")
        paths[f"{name}_rank{r['rank']}"] = c["launches"]
        print(f"{name} rank {r['rank']}: one request, the gathered stride-16 map within "
              f"{c['map_err']:.3g} of the unsharded extractor's largest value (tolerance "
              f"{SP_MAP_TOL:g}); {c['n']} detections, validity and labels equal to predict's, "
              f"max box diff {c['box_err']:.3g} px, max score diff {c['score_err']:.3g} (rtol, "
              f"atol {SP_BOX_TOL} px, {SP_SCORE_TOL}); launches "
              f"{c['launches']}; {c['ms']:.2f} ms against predict's {c['plain_ms']:.2f} ms; "
              f"{c['exchanges']} exchanges move {c['bytes']['halo'] / 2**20:.2f} MiB of halos and "
              f"{c['bytes']['gather'] / 2**20:.2f} MiB of gathered map in {c['exchange_ms']:.2f} "
              f"ms replayed alone  ({card})")
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}, "
          f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    counting = build_kernels()
    nms = check_nms_kernel(card)
    roi = check_roi_kernel(card)
    train_kernels = check_training_kernels(card, counting)
    bf16_kernels = {**check_bf16_forward(card), **check_bf16_backward(card)}
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    requests = make_requests()
    paths, served = {}, {}
    for model_type in ("faster_rcnn", "fpn"):
        paths[model_type], served[model_type] = drive_path(model_type, requests, card)
    paths["frcnn_vgg16"], served["vgg16"] = drive_path("faster_rcnn", requests, card,
                                                       backbone="vgg16", path="frcnn_vgg16")
    for model_type in ("faster_rcnn", "fpn"):
        paths[f"{model_type}_bf16"] = drive_path(model_type, requests, card, "bfloat16",
                                                 served[model_type])[0]
    paths["frcnn_vgg16_bf16"] = drive_path("faster_rcnn", requests, card, "bfloat16",
                                           served["vgg16"], "vgg16", "frcnn_vgg16_bf16")[0]
    paths["frcnn_coco"], served["coco"] = drive_path("faster_rcnn", requests, card,
                                                     path="frcnn_coco", data_type="coco")
    paths["frcnn_coco_bf16"] = drive_path("faster_rcnn", requests, card, "bfloat16",
                                          served["coco"], path="frcnn_coco_bf16",
                                          data_type="coco")[0]
    for backbone in ("resnet101", "resnet152"):
        for model_type in ("faster_rcnn", "fpn"):
            path = f"{PATH_NAME[model_type]}_{backbone}"
            paths[path] = drive_batch(path, model_type, backbone,
                                      config_factory("pascal", model_type), requests, card)
    paths.update(drive_slim(requests, card))
    print(f"serving phases done at {time.perf_counter() - t_start:.1f} s")
    bare_ms = {}
    for model_type in ("fpn", "faster_rcnn"):
        trained, bare_ms[model_type] = drive_training(model_type, card)
        paths.update(trained)
    paths.update(drive_training("faster_rcnn", card, backbone="vgg16", steps=VGG16_STEPS)[0])
    trained, bare_ms["frcnn_coco"] = drive_training("faster_rcnn", card, steps=COCO_STEPS,
                                                    data_type="coco")
    paths.update(trained)
    for model_type in ("fpn", "faster_rcnn"):
        paths.update(drive_training(model_type, card, "bfloat16")[0])
    paths.update(drive_training("faster_rcnn", card, "bfloat16", "vgg16", VGG16_STEPS)[0])
    print(f"training phases done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_voc_eval(requests, card))
    print(f"eval phase done at {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        voc, records = write_rehearsal_tree(Path(tmp))
        for model_type in ("faster_rcnn", "fpn"):
            paths.update(drive_trainer(model_type, voc, records, bare_ms[model_type], card))
        paths.update(drive_coco_trainer(Path(tmp) / "coco", bare_ms["frcnn_coco"], card))
    print(f"trainer phases done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_imports(requests, card))
    paths.update(drive_adam(card))
    paths.update(drive_debug(card))
    print(f"import, adam and debug phases done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_export(requests, card))
    print(f"export phase done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_data_parallel(requests, card))
    print(f"data-parallel phase done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_spatial(requests, card))
    print(f"spatial phase done at {time.perf_counter() - t_start:.1f} s")

    per_level_shape = "B=1 N=256 S=14 C=256, one launch per level P2..P5"
    fused_shape = "B=1 N=256 S=14 C=256, P2..P5 of 640x1024"
    main_cases = {  # kernel -> (its records, the main-path case, the case's shape)
        "nms_alive_sorted": (nms, NMS_MAIN, "[4,6000]->1000 @0.7"),
        "roi_align_multilevel": (roi, "served", "B=4 N=1000 S=14 C=256, P2..P5 of 640x1024"),
        **{k: (train_kernels[k], "train_b1", shape) for k, shape in (
            ("roi_align_single_level", per_level_shape),
            ("roi_align_single_level_backward", per_level_shape),
            ("roi_align_multilevel_backward", fused_shape))},
        "roi_align_multilevel_bf16": (bf16_kernels["roi_align_multilevel_bf16"], "served",
                                      "B=4 N=1000 S=14 C=256, bf16 P2..P5 of 640x1024"),
        **{k: (bf16_kernels[k], "train_b1", "bf16 planes, " + shape) for k, shape in (
            ("roi_align_single_level_bf16", per_level_shape),
            ("roi_align_single_level_backward_bf16", per_level_shape),
            ("roi_align_multilevel_backward_bf16", fused_shape))},
    }
    rows = []
    for name, (kernel, dtype, replaces) in KERNELS.items():
        records, case, shape = main_cases[name]
        rec = records[case]
        row = {
            "name": name,
            "route": "cuda",
            "operator": OPERATORS[name.removesuffix("_bf16")],
            "source": kernel.source,
            "replaces": replaces,
            "plane_dtype": dtype,
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {m: p[name] for m, p in paths.items()},
            "shape": shape,
            "max_abs_err": max(r["max_abs_err"] for r in records.values()),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the same function
        }
        if "near_reference_ms" in rec:
            row["near_reference_ms"] = rec["near_reference_ms"]
            row["near_reference"] = ("autograd backward of torch.nn.functional.grid_sample, one "
                                     "call per level" if "backward" in name else
                                     "torch.nn.functional.grid_sample, one call per level")
        for key in ("terms", "reductions", "cast_ms", "float32_planes_ms"):
            if key in rec:
                row[key] = rec[key]
        if name == "nms_alive_sorted":  # every shape of the kernel phase, COCO's too
            row["per_shape"] = records
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(sys.argv[3], int(sys.argv[2])))
    if sys.argv[1:2] == ["--sp-rank"]:
        sys.exit(sp_rank(sys.argv[3], int(sys.argv[2])))
    sys.exit(main())
