#!/usr/bin/env python3
"""A/B of the port's NMS (K1), RoIAlign forward (K4 / K2) and RoIAlign
backward (K5 / K3) CUDA kernels against another checkout's, on one NVIDIA GPU.

    python3 kernel_ab.py --other PATH [--rounds 2] [--parts nms,forward,backward]

PATH is the root of another checkout of this repository, for example the
parent commit unpacked with `git archive`. Run from the root of this
checkout on a machine with a CUDA GPU and nvcc. It imports nothing of JAX.

1. Builds `csrc/nms.cu`, `csrc/roi_align.cu` and `csrc/roi_align_backward.cu`
   of both checkouts with the flags of `ops/kernels/build.py` (all at
   once), this checkout's NMS scan once more with clock64 counters
   (`scan_clocks`), and this checkout's backward once more with its
   reductions replaced by plain stores (`stores_only`: a diagnostic of
   what the reductions cost, whose output is not the gradient).
2. K1 at `chip_smoke.py`'s NMS shapes: both index-exact against the plain
   version; times from CUDA-graph replays in the order other, this, this,
   other (`--rounds` such pairs); each stage's device time from
   torch.profiler; the scan's cycles per word in block 0, split into warp
   0's gather and word resolution, the other warps' OR step and thread 0's
   barrier wait.
3. K4 at the served (B=4, N=1000) and training (B=1, N=256) fixtures, on
   an edge / invalid / aspect-30 fixture and on its scalar path (C = 42,
   planes 4 bytes off alignment), and K2 (one launch per level at B=1,
   N=256): this checkout's output equal bit for bit to the other's; times
   as for K1. Then both at image extents past the
   planes, held against the plain version (this checkout must agree within
   atol/rtol 1e-5; the other's error is printed).
4. K5 at the training fixtures (B=1, N=256 with dense g and with the 2x2
   max pool's sparse g; B=4) and K3 (one launch per level at B=1): the two
   checkouts' gradients within 1e-5 of sum |g * w| of each other (float
   atomics add in no fixed order); times as for K1, and the stores-only
   build's beside this checkout's.

`--parts` picks which of 2-4 run (all by default).

Prints one line per case with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tf_eager_object_detection_tpu_torch.ops import nms as nms_mod
from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import CudaNms
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    CudaRoiAlignBackward,
)
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    _ARGS_HEAD,
    _ARGS_TAIL,
    CudaRoiAlign,
)

CSRC = Path("tf_eager_object_detection_tpu_torch") / "csrc"
OUT = Path("build") / "kernel_ab"

# clock64 counters of block 0 in the scan of csrc/nms.cu, inserted before
# the named lines of that source: (line, code to insert before it)
_SCAN_PROBES = [
    ("  int kept = 0;  // warp 0's running count",
     "  long long p_gather = 0, p_resolve = 0, p_or = 0, p_wait = 0, p_words = 0;\n"
     "  const long long t_start = clock64();\n"),
    ("    const int* prev = rows[(w + 1) & 1];", "    const long long t_a = clock64();\n"),
    ("      // Word w's greedy set: the fixpoint", "      const long long t_b = clock64();\n"),
    ("      // publish word w's kept boxes",
     "      const long long t_c = clock64();\n"
     "      if (lane == 0) { p_gather += t_b - t_a; p_resolve += t_c - t_b; }\n"),
    ("    // removed[w+1] now lacks only word w's rows",
     "    const long long t_pre = clock64();\n    if (tid == 32) p_or += t_pre - t_a;\n"),
    ("    if (kept_total[w & 1] >= max_output) break;",
     "    if (tid == 0) { p_wait += clock64() - t_pre; ++p_words; }\n"),
]
_SCAN_REPORT = """
  if (blockIdx.x == 0 && tid == 0) {
    g_clocks[0] = p_gather; g_clocks[1] = p_resolve; g_clocks[3] = p_wait;
    g_clocks[4] = p_words; g_clocks[5] = clock64() - t_start;
  }
  if (blockIdx.x == 0 && tid == 32) g_clocks[2] = p_or;
"""


def scan_clocks(src: str) -> str:
    """csrc/nms.cu with clock64 counters in its scan, read by `nms_scan_clocks`."""
    for line, probe in _SCAN_PROBES:
        if src.count(line) != 1:
            raise ValueError(f"nms.cu has no single line {line!r} to probe")
        src = src.replace(line, probe + line)
    end = "    if (kept_total[w & 1] >= max_output) break;\n  }\n"
    src = src.replace(end, end + _SCAN_REPORT, 1)
    src = src.replace("namespace {\n", "namespace {\n__device__ long long g_clocks[6];\n", 1)
    return src + """
extern "C" int nms_scan_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks)));
}
"""


def stores_only(src: str) -> str:
    """csrc/roi_align_backward.cu with plain stores in place of its reductions:
    the same loads, taps and addresses, no read-modify-write at the L2."""
    for line in cs.REDUCE_LINES:
        if src.count(line) != 1:
            raise ValueError(f"roi_align_backward.cu has no single line {line!r}")
        src = src.replace(line, line.replace("atomicAdd(dst, v);", "*dst = v;"))
    return src


def build(tag: str, files: dict[str, str]) -> ctypes.CDLL:
    lib, log = cs.build_variant(tag, files, OUT)
    for line in log.splitlines():
        if tag.startswith("bwd") and ("registers" in line or "spill" in line):
            print(f"{tag} ptxas: {line.strip()}")
    return lib


attach = cs.attach


class RoiAlignNoVec(CudaRoiAlign):
    """The forward's C interface before it took the `vec` flag."""

    argtypes = (*_ARGS_HEAD, *_ARGS_TAIL)

    def __call__(self, p_list, rois, levels, valid, ih, iw, crop, strides):
        p_list = list(p_list)
        self._check(p_list, rois, levels, valid, ih, iw, crop, strides)
        b, n, _ = rois.shape
        out = torch.empty((b, n, crop, crop, p_list[0].shape[-1]), device=rois.device)
        self._launch(p_list, rois, levels, valid, ih, iw, crop, strides, out)
        return out


def roi_kernel(lib, src: str):
    takes_vec = re.search(r"int crop, int vec,", src) is not None
    return attach(CudaRoiAlign() if takes_vec else RoiAlignNoVec(), lib)


class BackwardNoVec(CudaRoiAlignBackward):
    """The backward's C interface before it took the `vec` flag."""

    argtypes = (*_ARGS_HEAD, *_ARGS_TAIL)

    def __call__(self, grad, plane_shapes, rois, levels, valid, ih, iw, crop, strides):
        dfs = [torch.zeros(tuple(s), device=rois.device) for s in plane_shapes]
        self._check(dfs, rois, levels, valid, ih, iw, crop, strides)
        self._launch(dfs, rois, levels, valid, ih, iw, crop, strides, grad)
        return dfs


def backward_kernel(lib, src: str):
    takes_vec = re.search(r"int crop, int vec,", src) is not None
    return attach(CudaRoiAlignBackward() if takes_vec else BackwardNoVec(), lib)


def stage_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel `fn` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(nms_\w+_kernel|roi_align_\w+_kernel)", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = round(e.self_device_time_total / 1e3 / calls, 4)
    return out


def ab_times(pair: dict, call, rounds: int) -> dict:
    """{side: [ms, ...]} from graph replays, other, this, this, other per round."""
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            times[side].append(cs.graph_ms(lambda: call(pair[side])))
    return times


def fmt(times: dict) -> str:
    return ", ".join(f"{side} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                     for side, ts in times.items())


def ab_nms(libs, rounds: int, card: str) -> None:
    nms = {side: attach(CudaNms(), libs[f"nms_{side}"]) for side in ("other", "this")}
    clocks_lib = libs["nms_clocks"]
    clocks_lib.nms_scan_clocks.argtypes = [ctypes.c_void_p]
    clocked = attach(CudaNms(), clocks_lib)
    rng = np.random.RandomState(0)
    for name, b, k, max_out, thr in cs.NMS_CASES:
        boxes, valid = cs.nms_fixture(rng, b, k)
        tb, tv = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        ref = nms_mod.nms_alive_sorted_reference(tb, tv, thr, max_out)
        for side, kernel in (*nms.items(), ("this with clocks", clocked)):
            got = kernel(tb, tv, thr, max_out)
            torch.cuda.synchronize()
            cs.require(torch.equal(got, ref),
                       f"K1 {side} differs from the plain version at {name}")
        buf = (ctypes.c_longlong * 6)()
        err = clocks_lib.nms_scan_clocks(buf)
        cs.require(err == 0, f"reading the scan's clocks failed: {err}")
        gather, resolve, or_step, wait, words, total = list(buf)
        per = max(words, 1)
        call = lambda kern: kern(tb, tv, thr, max_out)  # noqa: E731
        print(f"K1 {name} [{b},{k}]->{max_out}: both index-exact; graph-replay "
              f"{fmt(ab_times(nms, call, rounds))}; stages other "
              f"{stage_ms(lambda: call(nms['other']))}, this "
              f"{stage_ms(lambda: call(nms['this']))}; scan of row 0: {words} "
              f"words, {total / per:.0f} cycles a word (warp 0 gather {gather / per:.0f}, "
              f"resolve {resolve / per:.0f}; other warps' OR {or_step / per:.0f}; thread 0 "
              f"barrier wait {wait / per:.0f})  ({card})")


def ab_forward(libs, src, rounds: int, card: str) -> None:
    roi = {side: roi_kernel(libs[f"roi_{side}"], src[side]["roi_align.cu"])
           for side in ("other", "this")}
    rng = np.random.RandomState(1)
    served = cs.roi_fixture(rng, cs.BATCH, 1000,
                            [[600, 800], [600, 1000], [576, 768], [640, 853]])
    train = cs.roi_fixture(rng, 1, cs.TRAIN_ROIS, [[600, 800]], invalid=0.0)
    fits = [[600, 1000], [500, 380]]
    edges = cs.roi_fixture(rng, 2, 64, fits, invalid=0.3, special=True)
    cases = [("K4 served B=4 N=1000", [served]), ("K4 train B=1 N=256", [train]),
             ("K2 train B=1 N=256, 4 launches", cs.per_level(train)),
             ("K4 edges / invalid / aspect 30", [edges]),
             ("K4 C=42 (scalar path)",
              [cs.roi_fixture(rng, 2, 64, fits, c=42, invalid=0.3, special=True)]),
             ("K4 planes 4 bytes off alignment (scalar path)", [cs.misaligned(edges)])]
    for name, args_list in cases:
        call = lambda kern: [kern(*a) for a in args_list]  # noqa: E731
        other, this = call(roi["other"]), call(roi["this"])
        torch.cuda.synchronize()
        cs.require(all(torch.equal(o, t) for o, t in zip(other, this)),
                   f"{name}: the two kernels' outputs differ")
        del other, this
        print(f"{name}: outputs equal bit for bit; graph-replay "
              f"{fmt(ab_times(roi, call, rounds))}; stages other "
              f"{stage_ms(lambda: call(roi['other']))}, this "
              f"{stage_ms(lambda: call(roi['this']))}  ({card})")
    past = cs.roi_fixture(rng, 2, 64, cs.PAST_THE_PLANES, invalid=0.3, special=True)
    want = cs.plain_per_image(past)
    err = {side: float((roi[side](*past) - want).abs().max()) for side in ("other", "this")}
    cs.require(float(((roi["this"](*past) - want).abs() - 1e-5 * want.abs()).max()) <= 1e-5,
               "K4 past the planes: this checkout differs from the plain version")
    print(f"K4 image extents past the planes: max abs err against the plain version, other "
          f"{err['other']:.3g}, this {err['this']:.3g} (atol/rtol 1e-5)  ({card})")


def ab_backward(libs, src, rounds: int, card: str) -> None:
    bwd = {side: backward_kernel(libs[f"bwd_{side}"], src[side]["roi_align_backward.cu"])
           for side in ("other", "this")}
    stores = attach(CudaRoiAlignBackward(), libs["bwd_stores"])
    rng = np.random.RandomState(2)
    train = cs.roi_fixture(rng, 1, cs.TRAIN_ROIS, [[600, 800]], invalid=0.0)
    b4 = cs.roi_fixture(rng, cs.BATCH, cs.TRAIN_ROIS,
                        [[600, 800], [600, 1000], [576, 768], [640, 853]], invalid=0.0)
    cases = [("K5 train B=1 N=256, dense g", cs.dense_grad(train), [train]),
             ("K5 train B=1 N=256, pool-sparse g", cs.pooled_grad(train), [train]),
             ("K5 train B=4 N=256, dense g", cs.dense_grad(b4), [b4]),
             ("K3 train B=1 N=256, dense g, 4 launches", cs.dense_grad(train),
              cs.per_level(train))]
    for name, g, args_list in cases:
        def call(kern):
            return [d for a in args_list
                    for d in kern(g, [tuple(p.shape) for p in a[0]], *a[1:])]
        other, this = call(bwd["other"]), call(bwd["this"])
        torch.cuda.synchronize()
        scale = [m for a in args_list for m in cs.plain_backward(g.abs(), a)]
        worst = max(float(((t - o).abs() / m.clamp_min(1e-30)).max())
                    for o, t, m in zip(other, this, scale))
        cs.require(all(bool(((t - o).abs() <= 1e-5 * m).all())
                       for o, t, m in zip(other, this, scale)),
                   f"{name}: the kernels' gradients differ by more than 1e-5 of sum "
                   f"|g * w| (worst {worst:.3g})")
        del other, this, scale
        every = dict(bwd, stores=stores)
        print(f"{name}: gradients of this within {worst:.3g} of sum |g * w| of the other's "
              f"(tolerance 1e-5); graph-replay {fmt(ab_times(bwd, call, rounds))}; stores-only "
              f"diagnostic {cs.graph_ms(lambda: call(stores)):.4f} ms; stages "
              + ", ".join(f"{side} {stage_ms(lambda k=k: call(k))}" for side, k in every.items())
              + f"  ({card})")


PARTS = ("nms", "forward", "backward")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2, help="pairs of (other, this) timings")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {PARTS}")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes a subset of {PARTS}, got {args.parts}")
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    names = ("nms.cu", "roi_align.cu", "roi_align_backward.cu", "roi_align_common.cuh")
    src = {side: {name: (root / CSRC / name).read_text() for name in names}
           for side, root in (("other", args.other), ("this", Path(".")))}
    jobs = {}
    for side, s in src.items():
        common = {"roi_align_common.cuh": s["roi_align_common.cuh"]}
        if "nms" in parts:
            jobs[f"nms_{side}"] = {"nms.cu": s["nms.cu"]}
        if "forward" in parts:
            jobs[f"roi_{side}"] = {"roi_align.cu": s["roi_align.cu"], **common}
        if "backward" in parts:
            jobs[f"bwd_{side}"] = {"roi_align_backward.cu": s["roi_align_backward.cu"], **common}
    if "nms" in parts:
        jobs["nms_clocks"] = {"nms.cu": scan_clocks(src["this"]["nms.cu"])}
    if "backward" in parts:
        jobs["bwd_stores"] = {
            "roi_align_backward.cu": stores_only(src["this"]["roi_align_backward.cu"]),
            "roi_align_common.cuh": src["this"]["roi_align_common.cuh"]}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda kv: build(*kv), jobs.items())))
    if "nms" in parts:
        ab_nms(libs, args.rounds, card)
    if "forward" in parts:
        ab_forward(libs, src, args.rounds, card)
    if "backward" in parts:
        ab_backward(libs, src, args.rounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
