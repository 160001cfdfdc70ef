#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It imports nothing of JAX.

1. Prints the card's name and power limit; requires CUDA; turns TF32 off.
2. Builds the CUDA NMS kernel from `tf_eager_object_detection_tpu_torch/csrc`.
3. Holds the kernel against its plain PyTorch version at the serving shapes
   ([1, 6000] -> 300 at 0.7 for `predict`, [4, 6000] -> 300 at 0.7 for a
   served batch, [20, 300] -> 50 at 0.3 per class) and on a cluster-heavy
   fixture with padded slots ([1, 12000] -> 2000 at 0.7): index-exact, with
   both times from CUDA events.
4. Serves 8 synthetic VOC-sized requests through the port's main path:
   Faster R-CNN ResNet-50 at full width with seeded random weights, the
   stock Pascal config, `preprocess_eval_image` -> `batched_im_detect`
   (batch 4) -> `post_ops_prediction`, plus one `predict`. Checks shapes,
   finiteness, boxes inside the image, and that every NMS of the path went
   through the kernel. Holds `predict` on the card against the port's CPU
   path on a small input.
5. Prints a JSON line with the kernel's record, then as its last line
   `{"ok": true, "device": {...}}`. Any failure raises: exit code != 0.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.preprocessing import preprocess_eval_image
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import nms as nms_mod
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
from tf_eager_object_detection_tpu_torch.ops.prediction import post_ops_prediction
from tf_eager_object_detection_tpu_torch.ops.roi_align import roi_crop_faster_rcnn

BATCH = 4
# VOC-like raw sizes (h, w), landscape and portrait interleaved
REQUEST_SIZES = [(375, 500), (500, 375), (333, 500), (500, 333),
                 (375, 500), (500, 366), (366, 500), (500, 375)]
NMS_CASES = [  # (name, batch, boxes, max_output, iou threshold)
    ("rpn", 1, 6000, 300, 0.7),
    ("rpn_batch", BATCH, 6000, 300, 0.7),  # the RPN NMS of one served batch
    ("per_class", 20, 300, 50, 0.3),
    ("cluster_padded", 1, 12000, 2000, 0.7),
]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


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


def check_nms_kernel(card):
    """Kernel vs plain version at each case; returns (max_abs_err, ms, plain_ms),
    the times at the served batch's RPN shape."""
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
        print(f"nms {name} [{b},{k}]->{max_out} @{thr}: index-exact, kept/row "
              f"{int(kept.min())}..{int(kept.max())}, max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms  ({card})")
        record[name] = (err, ms, plain_ms)
    return max(r[0] for r in record.values()), record["rpn_batch"][1], record["rpn_batch"][2]


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


def check_against_cpu(cfg, card):
    """predict on the card against the port's CPU path (plain NMS, held against
    JAX by tests/test_torch_model.py) on a small input, same seeded weights.

    As in that test, the score layers are scaled so that random-weight scores
    separate (a tie may legitimately pick other proposals). Labels and
    validity exact; scores atol 1e-4; boxes atol 1e-3 px (an RPN delta that
    differs by ~1e-6 from summation order times anchor extents up to 512 px).
    """
    small = dict(cfg, rpn_proposal_test_pre_nms_sample_number=300,
                 rpn_proposal_test_after_nms_sample_number=50,
                 max_objects_per_image=10, max_objects_per_class_per_image=10)
    image = np.random.RandomState(1).randn(160, 160, 3).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        det = model_factory("faster_rcnn", "resnet50", small, device=device, seed=1)
        with torch.no_grad():
            det.rpn_head.rpn_score_conv.weight.mul_(5.0)
            det.roi_head.roi_head_score.weight.mul_(10.0)
        out.append([t.cpu() for t in det.predict(image, [144, 128])])
    (gb, gl, gs, gv), (cb, cl, cs, cv) = out
    require(torch.equal(gv, cv) and torch.equal(gl, cl), "cuda vs cpu: labels or validity differ")
    box_err = float((gb - cb).abs().max())
    score_err = float((gs - cs).abs().max())
    require(box_err <= 1e-3 and score_err <= 1e-4,
            f"cuda vs cpu: box err {box_err}, score err {score_err}")
    print(f"predict 160x160, cuda vs the port's cpu path: {int(gv.sum())} detections, labels "
          f"and validity equal, box err {box_err:.3g} px, score err {score_err:.3g}  ({card})")


def stage_breakdown(det, images, hw, card):
    """Host-clock time of each stage of one batch, synchronised between stages."""
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with torch.inference_mode():
        (feats, score, bbox), t_bb = timed(lambda: det._backbone_rpn(images))
        (rois, valid), t_rp = timed(lambda: det._proposals(score, bbox, hw))
        crops, t_crop = timed(lambda: roi_crop_faster_rcnn(
            feats, rois, det.stride, det.cfg["roi_pooling_size"], det.roi_max_pooling))
        _, t_head = timed(lambda: det.roi_head(crops.reshape(-1, *crops.shape[2:])))
    print(f"stages, batch {images.shape[0]} at {tuple(images.shape[1:3])}: backbone+rpn "
          f"{t_bb:.2f} ms, proposals (incl. NMS) {t_rp:.2f} ms, roi crop {t_crop:.2f} ms, "
          f"roi head {t_head:.2f} ms  ({card})")


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
    nms = [(re.search(r"nms_\w+_kernel", e.key), e) for e in kernels]
    print("  nms kernels: " + ", ".join(
        f"{m.group(0)} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for m, e in nms if m))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- build
    info = NMS_KERNEL.load()
    print(f"nms kernel: {'built' if info['built'] else 'loaded'} {info['path']} "
          f"in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # ---- kernel vs plain
    max_err, nms_ms, nms_plain_ms = check_nms_kernel(card)

    # ---- main path
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    check_against_cpu(cfg, card)
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=0)
    requests = make_requests()
    serve(det, requests, cfg)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    NMS_KERNEL.launches = 0
    results, latency, total, batches = serve(det, requests, cfg)
    padded, hw, *_ = preprocess_eval_image(requests[0], cfg)
    one = det.predict(padded, hw)
    one = type(one)(*(t.cpu() for t in one))
    launches = NMS_KERNEL.launches

    slots = cfg["max_objects_per_image"]
    check_detections(results, len(requests), slots)
    check_detections({0: (one, (int(hw[0]), int(hw[1])))}, 1, slots)
    # one batched RPN NMS per flushed batch, one class-batched NMS per image
    expected = batches + len(requests) + 2
    print(f"nms launches in the main path: {launches} (expected {expected}: {batches} RPN "
          f"batches + {len(requests)} per-class + 2 for predict)")
    require(launches == expected, f"NMS launches {launches} != expected {expected}")

    lat = np.sort(np.asarray(list(latency.values()))) * 1e3
    print(f"serving {len(requests)} requests, batch {BATCH}, incl. host preprocessing: "
          f"{len(requests) / total:.3f} images/s, per-request latency p50 "
          f"{np.percentile(lat, 50):.1f} ms max {lat[-1]:.1f} ms  ({card})")

    # device-side throughput on preprocessed inputs
    pre = [preprocess_eval_image(img, cfg) for img in requests]
    land = [p for p in pre if p[0].shape[0] == 608][:BATCH]
    images = torch.as_tensor(np.stack([p[0] for p in land]), device="cuda")
    hws = torch.as_tensor(np.stack([p[1] for p in land]), device="cuda")
    scales = torch.ones(BATCH, device="cuda")
    batch_ms = cuda_ms(lambda: det.im_detect_batch(images, hws, scales), iters=5)
    predict_ms = cuda_ms(lambda: det.predict(images[0], hws[0]), iters=5)
    print(f"im_detect_batch b{BATCH} 608x1008: {batch_ms:.2f} ms/batch = "
          f"{BATCH * 1e3 / batch_ms:.3f} images/s; predict b1: {predict_ms:.2f} ms  ({card})")
    stage_breakdown(det, images, hws, card)
    device_profile(lambda: det.im_detect_batch(images, hws, scales), card)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({card})")

    print(json.dumps({"kernels": [{
        "name": "nms_alive_sorted",
        "route": "cuda",
        "source": NMS_KERNEL.source,
        "replaces": "tf_eager_object_detection_tpu/ops/pallas/nms_pallas.py:28",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": nms_ms,
        "plain_ms": nms_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
