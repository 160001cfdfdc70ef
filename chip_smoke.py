#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It imports nothing of JAX.

1. Prints the card's name and power limit; requires CUDA; turns TF32 off.
2. Builds both CUDA kernels from `tf_eager_object_detection_tpu_torch/csrc`
   at once (one nvcc each) and prints their ptxas reports.
3. K1, the NMS kernel, against its plain PyTorch version: index-exact at the
   Faster R-CNN shapes ([1, 6000] -> 300 for `predict`, [4, 6000] -> 300 for
   a served batch, [20, 300] -> 50 per class), the FPN shapes ([4, 6000] ->
   1000, [20, 1000] -> 50) and a cluster-heavy fixture with padded slots
   ([1, 12000] -> 2000); both times from CUDA events.
4. K4, the fused-pyramid RoIAlign kernel, against its plain version within
   atol/rtol 1e-5 on N(0, 1) features: the served shape (B=4, N=1000, the
   four planes of a 640x1024 bucket, image extents below the bucket), the
   `predict` shape (B=1) and a fixture with invalid rois, rois on the valid
   extent's edge and a roi of aspect > 10; times of the kernel, the plain
   version (one image at a time) and, as a near-equivalent reference only,
   `grid_sample` over the four levels.
5. Faster R-CNN ResNet-50 serving, then FPN ResNet-50 serving, each at full
   width with seeded random weights and the stock Pascal config: 8 synthetic
   VOC-sized requests through `preprocess_eval_image` -> `batched_im_detect`
   (batch 4) -> `post_ops_prediction`, plus one `predict`. Checks shapes,
   finiteness, boxes inside the image, and that every NMS and RoIAlign of
   the path went through the kernels (launch counts set to 0 before each
   path and read after it). Holds `predict` on the card against the port's
   CPU path on a small input. Prints each model's batch time, stages, one
   profiled call and peak memory.
6. Prints a JSON line with both kernels' records, then as its last line
   `{"ok": true, "device": {...}}`. Any failure raises: exit code != 0.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.preprocessing import preprocess_eval_image
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as nms_mod
from tf_eager_object_detection_tpu_torch.ops import roi_align as roi_mod
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import ROI_ALIGN_KERNEL
from tf_eager_object_detection_tpu_torch.ops.prediction import post_ops_prediction

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
FPN_STRIDES = (4, 8, 16, 32)
FPN_BUCKET = (640, 1024)
CROP = 14
# NVIDIA H100 SXM, published: HBM bytes/s and float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NMS_OPS_PER_IOU = 15  # float ops of one IoU test in csrc/nms.cu::overlaps
ROI_OPS_PER_SAMPLE = 9  # 6 multiplies and 3 adds per sample and channel


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for work that moves `nbytes` and
    does `ops` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_kernels() -> None:
    """Both libraries built at once (nvcc runs outside the GIL)."""
    kernels = (NMS_KERNEL, ROI_ALIGN_KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        infos = list(pool.map(lambda k: k.load(), kernels))
    for kernel, info in zip(kernels, infos):
        print(f"{kernel.name} kernel: {'built' if info['built'] else 'loaded'} {info['path']} "
              f"in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print("  ptxas:", line.strip())


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
        ms = cuda_ms(lambda: NMS_KERNEL(tb, tv, thr, max_out), iters=50)
        plain_ms = cuda_ms(
            lambda: nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out), iters=5, warmup=1
        )
        bound_ms, bound_by = nms_bound(tb, tv, got, thr)
        print(f"nms {name} [{b},{k}]->{max_out} @{thr}: index-exact, kept/row "
              f"{int(kept.min())}..{int(kept.max())}, max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  ({card})")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    return record


# ------------------------------------------------------------------------- K4
def roi_fixture(rng, b, n, hws, c=256, invalid=0.02, special=False):
    """Planes of the FPN bucket, N(0, 1); rois inside each image's extent,
    levels by the FPN rule; with `special`, each image's first rois are its
    whole extent, its bottom-right corner and a roi of aspect 30."""
    planes = [torch.randn(b, -(-FPN_BUCKET[0] // s), -(-FPN_BUCKET[1] // s), c,
                          generator=torch.Generator().manual_seed(s)).cuda()
              for s in FPN_STRIDES]
    hws = np.asarray(hws, np.float32)
    h, w = hws[:, :1], hws[:, 1:]
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


def grid_sample_levels(args):
    """`grid_sample` per level on the same sample points, as a near-equivalent
    reference: it zeroes single taps outside the plane (not whole samples
    outside the valid extent) and takes one level per call. Returns a
    closure over inputs prepared outside the timing."""
    planes, rois, levels, valid, ih, iw, crop, strides = args
    prepared = []
    for plane, s in zip(planes, strides):
        h, w = plane.shape[1], plane.shape[2]
        ys, _ = roi_mod.level_sample_coords(rois[..., 1], rois[..., 3], ih, s, crop)
        xs, _ = roi_mod.level_sample_coords(rois[..., 0], rois[..., 2], iw, s, crop)
        gy = (ys * (2.0 / (h - 1)) - 1.0)[..., :, None].expand(*ys.shape, crop)
        gx = (xs * (2.0 / (w - 1)) - 1.0)[..., None, :].expand(*xs.shape[:-1], crop, crop)
        grid = torch.stack([gx, gy], -1).reshape(rois.shape[0], -1, crop, 2).contiguous()
        prepared.append((plane.permute(0, 3, 1, 2).contiguous(), grid))
    return lambda: [F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=True) for x, g in prepared]


def check_roi_kernel(card):
    """K4 vs its plain version; returns the served shape's record."""
    rng = np.random.RandomState(1)
    cases = [
        ("served", roi_fixture(rng, BATCH, 1000, [[600, 800], [600, 1000], [576, 768], [640, 853]])),
        ("predict", roi_fixture(rng, 1, 1000, [[600, 800]])),
        ("edges_invalid_elongated", roi_fixture(rng, 2, 64, [[600, 1000], [500, 380]],
                                                invalid=0.3, special=True)),
    ]
    record = {}
    for name, args in cases:
        got = ROI_ALIGN_KERNEL(*args)
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
        ms = cuda_ms(lambda: ROI_ALIGN_KERNEL(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain_per_image(args), iters=2, warmup=1)
        grid_ms = cuda_ms(grid_sample_levels(args), iters=10)
        bound_ms, bound_by = roi_bound(args)
        b, n = args[1].shape[:2]
        print(f"roi_align {name} [B={b}, N={n}, C={args[0][0].shape[-1]}]: max_abs_err {err:.3g} "
              f"(atol/rtol 1e-5), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), grid_sample x4 levels (near-equivalent "
              f"reference, not the same function) {grid_ms:.4f} ms  ({card})")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, grid_sample_ms=grid_ms)
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
            (rois, valid), t_rp = timed(lambda: det._proposals(score, bbox, hw))
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
    ours = [(re.search(r"(nms_\w+_kernel|roi_align_ml_kernel)", e.key), e) for e in kernels]
    print("  port kernels: " + ", ".join(
        f"{m.group(0)} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for m, e in ours if m))


def drive_path(model_type, requests, card):
    """One model's serving path; returns the kernel launches of its run."""
    cfg = dict(config_factory("pascal", model_type))
    check_against_cpu(model_type, cfg, card)
    det = model_factory(model_type, "resnet50", cfg, device="cuda", seed=0)
    serve(det, requests, cfg)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    NMS_KERNEL.launches = 0
    ROI_ALIGN_KERNEL.launches = 0
    results, latency, total, batches = serve(det, requests, cfg)
    padded, hw, *_ = preprocess_eval_image(requests[0], cfg)
    one = det.predict(padded, hw)
    one = type(one)(*(t.cpu() for t in one))
    launches = {"nms": NMS_KERNEL.launches, "roi_align": ROI_ALIGN_KERNEL.launches}

    slots = cfg["max_objects_per_image"]
    check_detections(results, len(requests), slots)
    check_detections({0: (one, (int(hw[0]), int(hw[1])))}, 1, slots)
    # one batched RPN NMS per flushed batch, one class-batched NMS per image;
    # FPN: one K4 launch per flushed batch and one for predict
    expected = {"nms": batches + len(requests) + 2,
                "roi_align": batches + 1 if model_type == "fpn" else 0}
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

    build_kernels()
    nms = check_nms_kernel(card)
    roi = check_roi_kernel(card)
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    requests = make_requests()
    paths = {m: drive_path(m, requests, card) for m in ("faster_rcnn", "fpn")}
    print(f"serving phases done at {time.perf_counter() - t_start:.1f} s")

    nms_main, roi_main = nms[NMS_MAIN], roi["served"]
    print(json.dumps({"kernels": [
        {
            "name": "nms_alive_sorted",
            "route": "cuda",
            "source": NMS_KERNEL.source,
            "replaces": "tf_eager_object_detection_tpu/ops/pallas/nms_pallas.py:28",
            "launches": sum(p["nms"] for p in paths.values()),
            "launches_by_path": {m: p["nms"] for m, p in paths.items()},
            "shape": "[4,6000]->1000 @0.7",
            "max_abs_err": max(r["max_abs_err"] for r in nms.values()),
            "ms": nms_main["ms"],
            "plain_ms": nms_main["plain_ms"],
            "bound_ms": nms_main["bound_ms"],
            "bound_by": nms_main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes NMS
        },
        {
            "name": "roi_align_multilevel",
            "route": "cuda",
            "source": ROI_ALIGN_KERNEL.source,
            "replaces": "tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py:664",
            "launches": sum(p["roi_align"] for p in paths.values()),
            "launches_by_path": {m: p["roi_align"] for m, p in paths.items()},
            "shape": "B=4 N=1000 S=14 C=256, P2..P5 of 640x1024",
            "max_abs_err": max(r["max_abs_err"] for r in roi.values()),
            "ms": roi_main["ms"],
            "plain_ms": roi_main["plain_ms"],
            "bound_ms": roi_main["bound_ms"],
            "bound_by": roi_main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the fused-pyramid crop
            "near_reference_ms": roi_main["grid_sample_ms"],
            "near_reference": "torch.nn.functional.grid_sample, one call per level",
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
