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
   1000, [20, 1000] -> 50) and a cluster-heavy fixture with padded slots
   ([1, 12000] -> 2000, the training RPN NMS). Kernel times come from
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
   boundary (both on the kernel's scalar path); times of the kernel, the
   plain version (one image at a time) and, as a near-equivalent reference
   only, `grid_sample` over the four levels.
5. K5 (the fused-pyramid backward), K3 (the single-level backward, one
   launch per level) and K2 (the single-level forward, one launch per level)
   against their plain versions at the stock training shape (B=1, N=256),
   at B=4, and on an overlap-heavy and an edge / invalid / aspect-30
   fixture, with N(0, 1) g; K5 and K3 also at B=1 with the training path's
   pool-sparse g (the 2x2 max pool's backward): each backward cell within
   1e-5 of sum |g * w| over its terms (float reductions add in no fixed
   order), K2 within atol/rtol 1e-5; errors, times from graph replays,
   bounds, the (tap, channel) terms the backward adds, and the reductions
   it issues (vector and scalar) as the counting build counts them, which
   must equal the count of a model of its walk (`backward_work`);
   `grid_sample` (its autograd backward for K5 / K3) per level as a
   near-equivalent reference only.
6. Faster R-CNN ResNet-50 serving, then FPN ResNet-50 serving, each at full
   width with seeded random weights and the stock Pascal config: 8 synthetic
   VOC-sized requests through `preprocess_eval_image` -> `batched_im_detect`
   (batch 4) -> `post_ops_prediction`, plus one `predict`. Checks shapes,
   finiteness, boxes inside the image, and that every NMS and RoIAlign of
   the path went through the kernels (launch counts set to 0 before each
   path and read after it). Holds `predict` on the card against the port's
   CPU path on a small input. Prints each model's batch time, stages, one
   profiled call and peak memory.
7. FPN ResNet-50 training, stock config, full width, seeded random weights:
   one loss + backward on the card, with cuDNN off and then on, against the
   port's CPU path (128x128, same weights and draws); then
   `preprocess_train_image` -> `make_train_step` for 8 steps at B=1
   (landscape and portrait interleaved), 3 at B=4 and 2 at B=1 with
   `tpu_roi_align_fused_levels` False, each path's launch counts set to 0
   before and checked after (per step: K1 1, K4 1, K5 1 fused; K1 1, K2 4,
   K3 4 per level); losses finite, sample counts as configured; step times,
   stages, one profiled step of each RoIAlign path, peak memory and conv +
   linear work per step.
8. Prints a JSON line with the five kernels' records, then as its last line
   `{"ok": true, "device": {...}}`. Any failure raises: exit code != 0.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.preprocessing import (
    preprocess_eval_image,
    preprocess_train_image,
)
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.layers import FrozenBatchNorm
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as nms_mod
from tf_eager_object_detection_tpu_torch.ops import roi_align as roi_mod
from tf_eager_object_detection_tpu_torch.ops.kernels import build as kb
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
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

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
]
NMS_MAIN = "fpn_rpn_batch"
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
CROP = 14
# NVIDIA H100 SXM, published: HBM bytes/s and float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NMS_OPS_PER_IOU = 15  # float ops of one IoU test in csrc/nms.cu::overlaps
ROI_OPS_PER_SAMPLE = 9  # 6 multiplies and 3 adds per sample and channel
BWD_OPS_PER_TAP = 2  # a multiply and an add per nonzero tap and channel
TRAIN_ROIS = 256  # roi_total_sample_number of the stock config
# the kernels of the port: launch counter and the TPU kernel it replaces
KERNELS = {
    "nms_alive_sorted": (NMS_KERNEL, "tf_eager_object_detection_tpu/ops/pallas/nms_pallas.py:28"),
    "roi_align_single_level": (ROI_ALIGN_SINGLE_KERNEL,
                               "tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py:67"),
    "roi_align_single_level_backward": (
        ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
        "tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py:176"),
    "roi_align_multilevel": (ROI_ALIGN_KERNEL,
                             "tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py:664"),
    "roi_align_multilevel_backward": (
        ROI_ALIGN_BACKWARD_KERNEL,
        "tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py:759"),
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
    for kernel, _ in KERNELS.values():
        kernel.launches = 0


def launch_counts() -> dict:
    return {name: kernel.launches for name, (kernel, _) in KERNELS.items()}


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
        boxes, valid = nms_fixture(rng, b, k)
        tb = torch.from_numpy(boxes).cuda()
        tv = torch.from_numpy(valid).cuda()
        got = NMS_KERNEL(tb, tv, thr, max_out)
        ref = nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        kept = got.sum(-1)
        require(torch.equal(got, ref), f"NMS kernel differs from the plain version at {name}: "
                f"{int((got != ref).sum())} slots")
        require(not bool((got & ~tv).any()) and int(kept.max()) <= max_out,
                f"NMS kernel kept invalid slots or too many at {name}")
        ms = graph_ms(lambda: NMS_KERNEL(tb, tv, thr, max_out), calls=10)
        plain_ms = cuda_ms(
            lambda: nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out), iters=5, warmup=1
        )
        bound_ms, bound_by = nms_bound(tb, tv, got, thr)
        print(f"nms {name} [{b},{k}]->{max_out} @{thr}: index-exact, kept/row "
              f"{int(kept.min())}..{int(kept.max())}, max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  ({card})")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    for name, b, k, max_out, thr, kind in NMS_EDGE_CASES:
        boxes, valid = nms_edge_fixture(rng, b, k, kind)
        tb = torch.from_numpy(boxes).cuda()
        tv = torch.from_numpy(valid).cuda()
        got = NMS_KERNEL(tb, tv, thr, max_out)
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
    """Bound of one K4 call on these inputs: the output and the small inputs
    once, the plane cells that in-range samples of valid rois touch once;
    9 float ops per in-range sample and channel."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    c = planes[0].shape[-1]
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
        nbytes += int(touched.sum()) * c * 4
    return bound(nbytes, samples * c * ROI_OPS_PER_SAMPLE)


def level_grids(args):
    """Each level's plane in NCHW and the `grid_sample` grid of every roi's
    sample points on it (align_corners: cell centres at -1 and 1)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    out = []
    for plane, s in zip(planes, strides):
        h, w = plane.shape[1], plane.shape[2]
        ys, _ = roi_mod.level_sample_coords(rois[..., 1], rois[..., 3], ih, s, crop)
        xs, _ = roi_mod.level_sample_coords(rois[..., 0], rois[..., 2], iw, s, crop)
        gy = (ys * (2.0 / (h - 1)) - 1.0)[..., :, None].expand(*ys.shape, crop)
        gx = (xs * (2.0 / (w - 1)) - 1.0)[..., None, :].expand(*xs.shape[:-1], crop, crop)
        grid = torch.stack([gx, gy], -1).reshape(rois.shape[0], -1, crop, 2).contiguous()
        out.append((plane.permute(0, 3, 1, 2).contiguous(), grid))
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
    ]
    record = {}
    for name, args in cases:
        got = ROI_ALIGN_KERNEL(*args)
        path = "float4" if vectorizable(args[0], got) else "scalar"
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


def plain_backward(g, args):
    """The plain backward one image at a time (autograd through the plain
    forward; its P2 matmul intermediates are ~1 GB per image at N=256)."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    per_image = [roi_mod.roi_align_multilevel_reference_backward(
        g[i:i + 1], [p[i:i + 1] for p in planes], rois[i:i + 1], levels[i:i + 1],
        valid[i:i + 1], ih[i:i + 1], iw[i:i + 1], crop, strides) for i in range(rois.shape[0])]
    return [torch.cat(ds) for ds in zip(*per_image)]


def axis_taps(lo, hi, dim, stride, crop, size):
    """Tap cells and weights [B, N, S, 2] of one axis, with the arithmetic of
    `taps` in csrc/roi_align_common.cuh, and the in-range samples [B, N, S]."""
    v, ok = roi_mod.level_sample_coords(lo, hi, dim, stride, crop)
    c0 = v.floor()
    w = torch.stack([(1.0 - (v - c0).abs()).clamp_min(0.0),
                     (1.0 - (v - (c0 + 1.0)).abs()).clamp_min(0.0)], -1)
    cells = torch.stack([c0, c0 + 1.0], -1).long().clamp_max(size - 1)
    return cells, w * ok[..., None], ok


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
            live_a = live_a | reach
            # a second tap clamped onto the plane's last column adds to column a
            second = (wx[..., j, 1] != 0) & (ix[..., j, 1] != ix[..., j, 0])
            live_b = live_b | (reach & second[..., None, None])
        reductions += int(((live_a.sum(-1, keepdim=True) + live_b.sum(-1, keepdim=True))
                           * row_taps).sum())
    return terms, live, reductions if vec else 0, 0 if vec else reductions


def backward_bound(g, args):
    """Bound of one backward call: g of the valid rois read once, every
    gradient plane written once (zeros plus the scatter), the small inputs;
    a multiply and an add per nonzero tap and nonzero channel of g. Also the
    work of `backward_work`."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    c = planes[0].shape[-1]
    work = backward_work(g, args)
    nbytes = int(valid.sum()) * crop * crop * c * 4 + sum(p.numel() * 4 for p in planes)
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
    gs = [g.permute(0, 4, 1, 2, 3).reshape(o.shape).contiguous() for o in outs]
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


def serve(det, requests, cfg):
    """All requests arrive at t0; returns ({index: (Detections on host, raw hw)},
    {index: latency s}, total s, batches flushed)."""
    t0 = time.perf_counter()
    items = (preprocess_eval_image(img, cfg) for img in requests)  # (padded, hw, scale, raw_h, raw_w)
    results, latency, per_bucket = {}, {}, {}
    for idx, item, (sm, deltas, rois, valid) in batched_im_detect(det, items, BATCH):
        raw_h, raw_w = item[3], item[4]
        bucket = item[0].shape[:2]
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
        dets = post_ops_prediction(
            sm, deltas, rois, valid, raw_h, raw_w,
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            max_num_per_class=cfg["max_objects_per_class_per_image"],
            max_num_per_image=cfg["max_objects_per_image"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            score_threshold=cfg["prediction_score_threshold"],
            min_edge=10.0,  # the VOC writer's min_size, on raw-image coordinates
            num_classes=det.num_classes,
        )
        results[idx] = (type(dets)(*(t.cpu() for t in dets)), (raw_h, raw_w))
        latency[idx] = time.perf_counter() - t0
    batches = sum(-(-n // BATCH) for n in per_bucket.values())
    return results, latency, time.perf_counter() - t0, batches


def check_detections(results, n, slots):
    require(sorted(results) == list(range(n)), f"results for {sorted(results)}")
    for idx, (d, (raw_h, raw_w)) in results.items():
        require(d.boxes.shape == (slots, 4) and d.scores.shape == (slots,),
                f"request {idx}: shape {tuple(d.boxes.shape)}")
        require(bool(torch.isfinite(d.boxes).all() and torch.isfinite(d.scores).all()),
                f"request {idx}: non-finite output")
        v = d.valid
        require(bool(v.any()), f"request {idx}: no detection")
        b = d.boxes[v]
        require(float(b.min()) >= 0.0 and float(b[:, 2].max()) <= raw_w - 1
                and float(b[:, 3].max()) <= raw_h - 1, f"request {idx}: box outside the image")
        require(bool(((d.labels[v] >= 1) & (d.labels[v] < 21)).all()), f"request {idx}: label")
        s = d.scores[v]
        require(bool((s > 0).all() and (s[:-1] >= s[1:]).all()), f"request {idx}: score order")


# model type -> (small-input overrides, image size, image_hw, rpn / roi score-layer scales)
CPU_CHECKS = {
    "faster_rcnn": (dict(rpn_proposal_test_pre_nms_sample_number=300,
                         rpn_proposal_test_after_nms_sample_number=50), 160, [144, 128], 5.0, 10.0),
    "fpn": (dict(rpn_proposal_test_pre_nms_sample_number=512,
                 rpn_proposal_test_after_nms_sample_number=64), 128, [120, 124], 20.0, 10.0),
}


def check_against_cpu(model_type, cfg, card):
    """predict on the card against the port's CPU path (plain NMS and
    RoIAlign, held against JAX by tests/test_torch_model.py and
    tests/test_torch_fpn.py) on a small input, same seeded weights.

    As in those tests, the score layers are scaled so that random-weight
    scores separate (a tie may legitimately pick other proposals). Labels
    and validity exact; scores atol 1e-4; boxes atol 1e-3 px (an RPN delta
    that differs by ~1e-6 from summation order times anchor extents up to
    512 px).
    """
    overrides, size, hw, rpn_scale, roi_scale = CPU_CHECKS[model_type]
    small = dict(cfg, max_objects_per_image=10, max_objects_per_class_per_image=10, **overrides)
    image = np.random.RandomState(1).randn(size, size, 3).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        det = model_factory(model_type, "resnet50", small, device=device, seed=1)
        with torch.no_grad():
            det.rpn_head.rpn_score_conv.weight.mul_(rpn_scale)
            det.roi_head.roi_head_score.weight.mul_(roi_scale)
        out.append([t.cpu() for t in det.predict(image, hw)])
    (gb, gl, gs, gv), (cb, cl, cs, cv) = out
    require(torch.equal(gv, cv) and torch.equal(gl, cl),
            f"{model_type} cuda vs cpu: labels or validity differ")
    box_err = float((gb - cb).abs().max())
    score_err = float((gs - cs).abs().max())
    require(box_err <= 1e-3 and score_err <= 1e-4,
            f"{model_type} cuda vs cpu: box err {box_err}, score err {score_err}")
    print(f"{model_type} predict {size}x{size}, cuda vs the port's cpu path: {int(gv.sum())} "
          f"detections, labels and validity equal, box err {box_err:.3g} px, score err "
          f"{score_err:.3g}  ({card})")


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def stage_breakdown(det, images, hw, card):
    """Host-clock time of each stage of one batch, synchronised between stages."""
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
    print(f"{det.model_type} stages, batch {images.shape[0]} at {tuple(images.shape[1:3])}: "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in zip(names, times)) + f"  ({card})")


def layer_flops(det, fn) -> int:
    """FLOPs (2 per multiply-add) of the Conv2d and Linear layers in one call of `fn`."""
    total = 0

    def count(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            total += 2 * out.numel() * mod.in_features

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
        return
    print(f"profile, one call: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}  ({card})")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    ours = [(re.search(r"(nms_\w+_kernel|roi_align_ml_\w*kernel)", e.key), e) for e in kernels]
    print("  port kernels: " + ", ".join(
        f"{m.group(0)} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for m, e in ours if m))


def drive_path(model_type, requests, card):
    """One model's serving path; returns the kernel launches of its run."""
    cfg = dict(config_factory("pascal", model_type))
    check_against_cpu(model_type, cfg, card)
    det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
    serve(det, requests, cfg)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    reset_launches()
    results, latency, total, batches = serve(det, requests, cfg)
    padded, hw, *_ = preprocess_eval_image(requests[0], cfg)
    one = det.predict(padded, hw)
    one = type(one)(*(t.cpu() for t in one))
    launches = launch_counts()

    slots = cfg["max_objects_per_image"]
    check_detections(results, len(requests), slots)
    check_detections({0: (one, (int(hw[0]), int(hw[1])))}, 1, slots)
    # one batched RPN NMS per flushed batch, one class-batched NMS per image;
    # FPN: one K4 launch per flushed batch and one for predict
    expected = dict.fromkeys(KERNELS, 0)
    expected["nms_alive_sorted"] = batches + len(requests) + 2
    expected["roi_align_multilevel"] = batches + 1 if model_type == "fpn" else 0
    print(f"{model_type} kernel launches in the main path: {launches} (expected {expected}: "
          f"{batches} batches, {len(requests)} per-class NMS, predict)")
    require(launches == expected, f"{model_type} launches {launches} != expected {expected}")

    lat = np.sort(np.asarray(list(latency.values()))) * 1e3
    print(f"{model_type} serving {len(requests)} requests, batch {BATCH}, incl. host "
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
    print(f"{model_type} im_detect_batch b{BATCH} {size}: {batch_ms:.2f} ms/batch = "
          f"{BATCH * 1e3 / batch_ms:.3f} images/s; predict b1: {predict_ms:.2f} ms  ({card})")
    tflop = layer_flops(det, lambda: det.im_detect_batch(images, hws, scales)) / 1e12
    print(f"{model_type} conv + linear work {tflop:.4f} TFLOP per batch: "
          f"{tflop / batch_ms * 1e3:.2f} TFLOP/s over the whole call, "
          f"{tflop / batch_ms * 1e3 / (F32_FLOP_PER_S / 1e12):.3f} of the f32 peak  ({card})")
    stage_breakdown(det, images, hws, card)
    device_profile(lambda: det.im_detect_batch(images, hws, scales), card)
    print(f"{model_type} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
          f"  ({card})")
    del det
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- training
# small-input overrides of the card-vs-CPU training step (as tests/test_torch_fpn_train.py)
TRAIN_CPU_CHECK = dict(rpn_proposal_train_pre_nms_sample_number=512,
                       rpn_proposal_train_after_nms_sample_number=64, rpn_total_sample_number=64,
                       rpn_pos_sample_max_number=32, roi_total_sample_number=32,
                       roi_pos_sample_max_number=8, tpu_max_gt_boxes=8)
# per training step: the RPN NMS, then K4 + K5 fused or K2 + K3 once per level
PER_STEP = {
    "fused": {"nms_alive_sorted": 1, "roi_align_multilevel": 1, "roi_align_multilevel_backward": 1},
    "per_level": {"nms_alive_sorted": 1, "roi_align_single_level": 4,
                  "roi_align_single_level_backward": 4},
}


# Card step vs the port's CPU step: every gradient within GRAD_TOL of its
# tensor's largest value (the tolerance of tests/test_torch_fpn_train.py) with
# cuDNN off, where the convolutions are PyTorch's own CUDA GEMMs; within
# CUDNN_GRAD_TOL with cuDNN on, whose FFT and Winograd convolutions round
# differently in float32 and move a few conv4 gradients of this random-weight
# network by more than GRAD_TOL (the check prints both worst cases).
GRAD_TOL = 2e-3
CUDNN_GRAD_TOL = 2e-2


def grads_close(got, want, tol) -> float:
    """Largest |got - want| / max|want| over the tensors; raises above `tol`."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        require(err <= tol, f"gradient of {name} differs by {err:.3g} of its largest value "
                f"(tolerance {tol})")
        worst = max(worst, err)
    return worst


def small_training_step(small, device, draws, inputs):
    """One loss and backward of a seeded FPN on the small input -> (metrics,
    gradients on the host)."""
    det = model_factory("fpn", "resnet50", small, device=device, seed=1)
    with torch.no_grad():
        det.rpn_head.rpn_score_conv.weight.mul_(20.0)
    total, metrics = det.loss_fn(*inputs, TrainDraws(*(t.to(device) for t in draws)))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in det.named_parameters()})


def check_training_against_cpu(cfg, card):
    """One training loss and backward on the card against the port's CPU path
    (held against JAX by tests/test_torch_fpn_train.py) on a 128x128 input,
    same seeded weights and the same draws: losses rtol 1e-4, counts exact,
    every gradient within GRAD_TOL (cuDNN off) or CUDNN_GRAD_TOL (cuDNN on)
    of its tensor's largest value. A RoI gradient that failed to reach the
    pyramid would show in the neck's and the backbone's gradients at O(1).
    The RPN score layer is scaled so that random-weight proposals separate,
    as in the CPU tests."""
    small = dict(cfg, tpu_image_buckets=[[128, 128]], image_min_size=128, image_max_size=128,
                 **TRAIN_CPU_CHECK)
    rng = np.random.RandomState(3)
    image = rng.randn(1, 128, 128, 3).astype(np.float32)
    hw = np.asarray([[120, 124]], np.int32)
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    gt_mask = np.arange(8)[None] < 3
    gt_labels = np.asarray([[3, 7, 12, 0, 0, 0, 0, 0]], np.int32)
    inputs = (image, hw, gt, gt_mask, gt_labels)
    anchors = 3 * sum((-(-128 // s)) ** 2 for s in small["anchor_stride_list"])
    draws = TrainDraws.sample(torch.Generator().manual_seed(5), 1, anchors, 64, 32)
    cm, cg = small_training_step(small, "cpu", draws, inputs)
    for cudnn, tol in ((False, GRAD_TOL), (True, CUDNN_GRAD_TOL)):
        torch.backends.cudnn.enabled = cudnn
        try:
            gm, gg = small_training_step(small, "cuda", draws, inputs)
        finally:
            torch.backends.cudnn.enabled = True
        for k in cm:
            ktol = 1e-4 * abs(cm[k]) if k.endswith("loss") else 0.0
            require(abs(gm[k] - cm[k]) <= ktol, f"training {k}: cuda {gm[k]} vs cpu {cm[k]}")
        worst = grads_close(gg, cg, tol)
        print(f"fpn training loss + backward 128x128, cuda (cuDNN {'on' if cudnn else 'off'}) vs "
              f"the port's cpu path: losses within rtol 1e-4 (total {gm['total_loss']:.6f} vs "
              f"{cm['total_loss']:.6f}), counts equal, {len(cg)} gradients within {worst:.3g} "
              f"of their largest value (tolerance {tol})  ({card})")


def make_train_items(seed: int = 0):
    """The 8 request images with 1-8 random gt boxes each: (raw RGB, boxes
    [n, 4] normalized yxyx, labels [n])."""
    rng = np.random.RandomState(seed + 1)
    items = []
    for img in make_requests(seed):
        n = rng.randint(1, 9)
        lo = rng.uniform(0.0, 0.7, (n, 2))
        hi = np.minimum(lo + rng.uniform(0.08, 0.6, (n, 2)), 1.0)
        boxes = np.concatenate([lo, hi], 1).astype(np.float32)
        items.append((img, boxes, rng.randint(1, 21, n).astype(np.int32)))
    return items


def train_batch(items, cfg, rng):
    """`preprocess_train_image` (random flip) on each item, stacked on the card."""
    pre = [preprocess_train_image(img, boxes, labels, cfg, rng) for img, boxes, labels in items]
    return tuple(torch.as_tensor(np.stack(x), device="cuda") for x in zip(*pre))


def train_path(name, step, batches, gen, cfg, per_step, card):
    """Steps over `batches` with the launch counts set to 0 before and read
    after; checks losses, sample counts and launches. Returns the counts."""
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
          f"rpn fg/bg {last['num_rpn_fg']:.0f}/{last['num_rpn_bg']:.0f}, roi fg "
          f"{last['num_roi_fg']:.0f}, proposals {last['num_proposals']:.0f}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({card})")
    return launches


def train_stages(det, opt, batch, gen, card):
    """Host-clock time of each stage of one step, synchronised between stages,
    and the step's conv + linear work (forward counted by hooks; the backward
    is twice the forward less conv1's input gradient, which no step needs)."""
    fwd = layer_flops(det, lambda: det.loss_fn(*batch, gen))
    conv1 = det.extractor.conv1_conv
    first = layer_flops(conv1, lambda: conv1(batch[0].permute(0, 3, 1, 2)))
    opt.zero_grad()
    (total, _), t_fwd = timed(lambda: det.loss_fn(*batch, gen))
    _, t_bwd = timed(total.backward)
    _, t_opt = timed(opt.step)
    tflop = (3 * fwd - first) / 1e12
    step_ms = t_fwd + t_bwd + t_opt
    print(f"fpn train stages, batch {batch[0].shape[0]} at {tuple(batch[0].shape[1:3])}: "
          f"forward + proposals + targets {t_fwd:.2f} ms, backward {t_bwd:.2f} ms, optimizer "
          f"{t_opt:.2f} ms; conv + linear work {tflop:.4f} TFLOP per step, "
          f"{tflop / step_ms * 1e3:.2f} TFLOP/s over the step, "
          f"{tflop / step_ms * 1e3 / (F32_FLOP_PER_S / 1e12):.3f} of the f32 peak  ({card})")


@torch.no_grad()
def calibrate_frozen_bn(det, images):
    """Set every FrozenBatchNorm's statistics to its input's per-channel mean
    and variance on `images`, in forward order, as a pretrained backbone's
    would normalize. Without it, random weights and caffe-scaled pixels give
    activations that grow through the 50 layers, logits in the hundreds,
    and training steps that diverge."""

    def hook(bn, inputs):
        x = inputs[0]
        bn.moving_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.moving_variance.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in det.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        det.extractor(images)
    finally:
        for h in handles:
            h.remove()


def drive_training(card):
    """FPN ResNet-50 training at full width, stock config, seeded random
    weights: 8 steps at B=1 (landscape and portrait interleaved), 3 at B=4
    (landscape), 2 at B=1 with `tpu_roi_align_fused_levels` False. Returns
    {path: launch counts}."""
    cfg = dict(config_factory("pascal", "fpn"))
    check_training_against_cpu(cfg, card)
    det = model_factory("fpn", "resnet50", cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, det)
    step = make_train_step(det, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    items = make_train_items()
    b1 = [train_batch([it], cfg, rng) for it in items]
    landscape = [it for it in items if it[0].shape[0] < it[0].shape[1]][:BATCH]
    b4 = [train_batch(landscape, cfg, rng) for _ in range(3)]
    calibrate_frozen_bn(det, b4[0][0])
    step(b1[0], gen)  # warm-up: cuDNN algorithm choice, allocator
    step(b4[0], gen)
    paths = {"fpn_train_b1": train_path("fpn_train_b1", step, b1, gen, cfg, PER_STEP["fused"], card),
             "fpn_train_b4": train_path("fpn_train_b4", step, b4, gen, cfg, PER_STEP["fused"], card)}
    for batch in (b1[0], b4[0]):
        train_stages(det, opt, batch, gen, card)
    device_profile(lambda: step(b1[0], gen), card)
    det.cfg["tpu_roi_align_fused_levels"] = False
    step(b1[1], gen)  # warm-up of the per-level path
    paths["fpn_train_per_level"] = train_path("fpn_train_per_level", step, b1[:2], gen, cfg,
                                              PER_STEP["per_level"], card)
    device_profile(lambda: step(b1[0], gen), card)
    del det, opt, step
    torch.cuda.empty_cache()
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    counting = build_kernels()
    nms = check_nms_kernel(card)
    roi = check_roi_kernel(card)
    train_kernels = check_training_kernels(card, counting)
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    requests = make_requests()
    paths = {m: drive_path(m, requests, card) for m in ("faster_rcnn", "fpn")}
    print(f"serving phases done at {time.perf_counter() - t_start:.1f} s")
    paths.update(drive_training(card))
    print(f"training phases done at {time.perf_counter() - t_start:.1f} s")

    main_cases = {  # kernel -> (its records, the main-path case, the case's shape)
        "nms_alive_sorted": (nms, NMS_MAIN, "[4,6000]->1000 @0.7"),
        "roi_align_multilevel": (roi, "served", "B=4 N=1000 S=14 C=256, P2..P5 of 640x1024"),
        **{k: (train_kernels[k], "train_b1", shape) for k, shape in (
            ("roi_align_single_level", "B=1 N=256 S=14 C=256, one launch per level P2..P5"),
            ("roi_align_single_level_backward",
             "B=1 N=256 S=14 C=256, one launch per level P2..P5"),
            ("roi_align_multilevel_backward", "B=1 N=256 S=14 C=256, P2..P5 of 640x1024"))},
    }
    rows = []
    for name, (kernel, replaces) in KERNELS.items():
        records, case, shape = main_cases[name]
        rec = records[case]
        row = {
            "name": name,
            "route": "cuda",
            "source": kernel.source,
            "replaces": replaces,
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
        if name != "nms_alive_sorted":
            row["near_reference_ms"] = rec["near_reference_ms"]
            row["near_reference"] = ("autograd backward of torch.nn.functional.grid_sample, one "
                                     "call per level" if name.endswith("backward") else
                                     "torch.nn.functional.grid_sample, one call per level")
        if "terms" in rec:
            row["terms"] = rec["terms"]
            row["reductions"] = rec["reductions"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
