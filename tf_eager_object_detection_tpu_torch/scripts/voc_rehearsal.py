"""20-class VOC rehearsal of the port: train and evaluate through the
port's command lines to an mAP (port of `scripts/voc_rehearsal.py`).

No VOC data is needed: `gen` draws a procedural 20-class VOC2007-layout
tree (600 trainval / 150 test images at 600x800, 3-7 objects each with
IoU < 0.3, difficult-flagged small objects, unlabeled gray distractors;
each class a saturated base color times a texture) with the same
`np.random.RandomState` draw order and cv2 JPEG quality (92) as the JAX
script, so a seed gives the same tree in both. The stock Pascal config
trains on it from random weights; the only non-stock knob is the learning
rate (`--lr`, 2.5e-4: the stock 1e-3 diverges from random weights).

    python -m tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal gen   --root DIR
    python -m tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal train --steps 16000
    python -m tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal eval
    python -m tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal run   # all three
    python -m tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal coco

`run` and `eval` exit 1 when the mAP is below 0.85, as the JAX script does.
`coco` scores the trained checkpoint on the test split through `eval_coco`
(the test annotations written as a COCO file, difficult objects as
`iscrowd`) and prints `COCO_REHEARSAL {json}` with the 12 COCO stats.
Training is one process (the JAX script's `--chunks` worked around a
leak of its TPU runtime). `consistency` evaluates the trained checkpoint
on the first `--n_consistency` test images twice on the CPU, as JAX runs
it on 8 CPU devices: on one device, one image at a time, and with
`--data_parallel 8` at batch 8 (eight replicas, one image each), and as
`--spatial_partition 4` (four gloo ranks on the CPU started by the script,
torchrun's environment over a free local port, each image's rows sharded
over them, one image at a time), and prints `CONSISTENCY {json}`. It exits
1 unless every variant's VOC detection files equal the single variant's:
byte for byte, or, where a printed digit moved, with the same lines but
for scores within SCORE_BOUND and coordinates within BOX_BOUND px (each
differing line is printed), and the mAPs within MAP_BOUND. JAX's single
variant runs at batch 8, where XLA's per-image numerics do not depend on
the batch; the CPU's convolutions here do, in the last bits, and so do
its convolutions of a shard's rows against the whole map's, which can
move a printed digit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np

from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_PKG = "tf_eager_object_detection_tpu_torch.scripts"

IMG_H, IMG_W = 600, 800  # scale = min(600 / 600, 1000 / 800) = 1.0 under the stock rule

BASE_COLORS = (
    (205, 40, 40),    # red
    (40, 190, 40),    # green
    (50, 70, 220),    # blue
    (230, 200, 40),   # yellow
    (200, 50, 200),   # magenta
)
PERIOD = 24  # texture period in pixels


def class_patch(ci: int, h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """Textured uint8 [h, w, 3] patch of class index ci (0..19)."""
    base = np.array(BASE_COLORS[ci % 5], np.float32)
    second = base * 0.3
    jit = rng.uniform(0.8, 1.15)
    yy, xx = np.mgrid[0:h, 0:w]
    pattern = ci // 5  # 0 solid / 1 horizontal stripes / 2 vertical stripes / 3 checker
    if pattern == 0:
        mask = np.ones((h, w), bool)
    elif pattern == 1:
        mask = (yy // PERIOD) % 2 == 0
    elif pattern == 2:
        mask = (xx // PERIOD) % 2 == 0
    else:
        mask = ((yy // PERIOD) + (xx // PERIOD)) % 2 == 0
    patch = np.where(mask[..., None], base, second) * jit
    patch += rng.normal(0.0, 6.0, patch.shape)
    return np.clip(patch, 0, 255).astype(np.uint8)


def _overlaps(a, boxes):
    """(max IoU, max intersection over the smaller area) of box a against boxes."""
    if not boxes:
        return 0.0, 0.0
    b = np.asarray(boxes, np.float32)
    ix = np.maximum(0.0, np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]))
    iy = np.maximum(0.0, np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area_a + area_b - inter, 1.0)
    ioa = inter / np.maximum(np.minimum(area_a, area_b), 1.0)
    return float(np.max(iou)), float(np.max(ioa))


def _place_box(rng, placed, smin, smax, max_iou=0.3, max_ioa=0.4, tries=40):
    """Rejection-sample an xyxy box of sqrt-area in [smin, smax] that
    overlaps every placed box by IoU < max_iou and intersection over the
    smaller area < max_ioa; None after `tries` draws."""
    for _ in range(tries):
        s = rng.uniform(smin, smax)
        a = np.exp(rng.uniform(np.log(0.45), np.log(2.2)))
        w = min(s * np.sqrt(a), IMG_W - 16.0)
        h = min(s / np.sqrt(a), IMG_H - 16.0)
        x1 = rng.uniform(4, IMG_W - w - 4)
        y1 = rng.uniform(4, IMG_H - h - 4)
        box = (x1, y1, x1 + w, y1 + h)
        iou, ioa = _overlaps(np.asarray(box), placed)
        if iou < max_iou and ioa < max_ioa:
            return box
    return None


def draw_image(rng: np.random.RandomState):
    """-> (uint8 [600, 800, 3], [(class_name, x1, y1, x2, y2, difficult)])"""
    img = rng.randint(0, 55, (IMG_H, IMG_W, 3)).astype(np.uint8)
    for _ in range(rng.randint(3, 7)):  # unlabeled low-saturation distractors
        g = rng.randint(70, 160)
        col = np.clip(np.array([g, g, g]) + rng.randint(-18, 18, 3), 0, 255).astype(np.uint8)
        dw, dh = rng.randint(40, 200), rng.randint(40, 200)
        dx, dy = rng.randint(0, IMG_W - dw), rng.randint(0, IMG_H - dh)
        img[dy : dy + dh, dx : dx + dw] = col

    objs, placed = [], []
    n_normal = rng.randint(3, 8)
    n_difficult = int(rng.uniform() < 0.5) + int(rng.uniform() < 0.2)
    specs = [(False, 110.0, 420.0)] * n_normal + [(True, 48.0, 90.0)] * n_difficult
    rng.shuffle(specs)
    for difficult, smin, smax in specs:
        box = _place_box(rng, placed, smin, smax)
        if box is None:
            continue
        placed.append(box)
        ci = rng.randint(0, 20)
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        x2, y2 = min(x2, IMG_W - 1), min(y2, IMG_H - 1)
        objs.append((PASCAL_CLASSES[ci], x1, y1, x2, y2, int(difficult)))
    # large before small: no small object is buried
    for c, x1, y1, x2, y2, _d in sorted(objs, key=lambda o: (o[3] - o[1]) * (o[4] - o[2]),
                                        reverse=True):
        img[y1:y2, x1:x2] = class_patch(PASCAL_CLASSES.index(c), y2 - y1, x2 - x1, rng)
    return img, objs


def generate(root: str, n_train: int, n_test: int, seed: int = 0):
    """Write a VOC2007-layout tree with trainval / test splits; returns the
    test split's non-difficult object count per class."""
    import cv2

    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    splits = {"trainval": [], "test": []}
    counts = {c: 0 for c in PASCAL_CLASSES}
    for i in range(n_train + n_test):
        image_id = f"{i:06d}"
        split = "trainval" if i < n_train else "test"
        splits[split].append(image_id)
        img, objs = draw_image(rng)
        cv2.imwrite(os.path.join(root, "JPEGImages", image_id + ".jpg"),
                    img[:, :, ::-1],  # RGB -> BGR for cv2
                    [int(cv2.IMWRITE_JPEG_QUALITY), 92])
        obj_xml = "".join(
            f"<object><name>{c}</name><difficult>{d}</difficult>"
            f"<bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for c, x1, y1, x2, y2, d in objs
        )
        with open(os.path.join(root, "Annotations", image_id + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{image_id}.jpg</filename>"
                    f"<size><width>{IMG_W}</width><height>{IMG_H}</height>"
                    f"<depth>3</depth></size>{obj_xml}</annotation>")
        if split == "test":
            for c, *_rest, d in objs:
                if not d:
                    counts[c] += 1
    for mode, ids in splits.items():
        with open(os.path.join(root, "ImageSets", "Main", mode + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    if min(counts.values()) == 0:
        raise ValueError(f"test split missing classes (more test images needed): {counts}")
    return counts


def _run(cmd, **kw):
    print("+ " + " ".join(cmd), flush=True)
    return subprocess.run(cmd, check=True, cwd=REPO, **kw)


def _module(name: str):
    return [sys.executable, "-m", f"{_PKG}.{name}"]


def cmd_gen(args):
    voc_root = os.path.join(args.root, "VOC2007")
    if os.path.exists(voc_root):
        shutil.rmtree(voc_root)
    counts = generate(voc_root, args.n_train, args.n_test, args.seed)
    devkit = os.path.join(args.root, "VOCdevkit")
    os.makedirs(devkit, exist_ok=True)
    link = os.path.join(devkit, "VOC2007")
    if not os.path.exists(link):
        os.symlink(voc_root, link)
    tfr = os.path.join(args.root, "tfrecords")
    if os.path.exists(tfr):
        shutil.rmtree(tfr)
    _run(_module("generate_pascal_tf_records")
         + ["--voc_root", devkit, "--year", "2007", "--mode", "trainval",
            "--output_dir", tfr, "--num_shards", "4"])
    print(json.dumps({"gen": "ok", "test_obj_counts": counts}))


def _dirs(args):
    voc_root = os.path.join(args.root, "VOC2007")
    logs = os.path.join(args.root, f"logs_{args.model_type}_{args.backbone}")
    return voc_root, os.path.join(args.root, "tfrecords"), logs


def cmd_train(args):
    _, tfr, logs = _dirs(args)
    if os.path.exists(logs) and not args.resume:
        shutil.rmtree(logs)
    cmd = _module("train") + [
        "--model_type", args.model_type, "--backbone", args.backbone,
        "--data_type", "pascal", "--tf_records_dir", tfr,
        "--logs_dir", logs, "--epochs", "1",
        "--steps_per_epoch", str(args.steps),
        "--logging_every_n_steps", "200",
        "--summary_every_n_steps", str(max(args.steps // 2, 1)),
        "--saving_every_n_steps", str(args.steps),
        "--batch_size", str(args.batch_size),
        "--seed", str(args.seed),
        "--device", args.device,
    ]
    if args.lr > 0:  # 0 = keep the config's (possibly overridden) schedule
        cmd += ["--learning_rate", str(args.lr)]
    for ov in args.config_override:
        cmd += ["--config_override", ov]
    if args.compute_dtype:
        cmd += ["--compute_dtype", args.compute_dtype]
    _run(cmd)


def cmd_eval(args):
    voc_root, _, logs = _dirs(args)
    result_dir = os.path.join(args.root, f"results_{args.model_type}_{args.backbone}")
    if os.path.exists(result_dir):
        shutil.rmtree(result_dir)
    cmd = _module("eval_pascal") + [
        logs, "--root_path", voc_root, "--model_type", args.model_type,
        "--backbone", args.backbone, "--mode", "test", "--result_dir", result_dir,
        "--batch_size", str(args.eval_batch_size), "--device", args.device,
    ]
    for ov in args.config_override:
        cmd += ["--config_override", ov]
    out = _run(cmd, capture_output=True, text=True)
    sys.stderr.write(out.stderr[-1500:])
    print(out.stdout[-3000:])
    aps = {}
    for line in out.stdout.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[1] == "AP" and parts[2] == "=":
            aps[parts[0]] = float(parts[3])
    per_class = {c: aps.get(c, -1.0) for c in PASCAL_CLASSES}
    summary = {
        "proof": "voc_rehearsal",
        "model_type": args.model_type,
        "backbone": args.backbone,
        "per_class_ap": per_class,
        "mAP": float(np.mean(list(per_class.values()))),
        "classes_populated": sum(v >= 0.0 for v in per_class.values()),
    }
    print("VOC_REHEARSAL " + json.dumps(summary))
    return summary


# "single" evaluates one image at a time, as each of dp8's replicas and
# sp4's ranks do: a device at batch 8 sums its convolutions in another order
# than at batch 1 (the CPU library's, and cuDNN's, choice by batch size),
# which may move a printed digit of a detection file
CONSISTENCY_VARIANTS = {"single": ["--batch_size", "1"],
                        "dp8": ["--batch_size", "8", "--data_parallel", "8"],
                        "sp4": ["--batch_size", "1", "--spatial_partition", "4"]}
SPATIAL_RANKS = 4
# a detection line of another variant whose printed digits moved (a score
# printed with 3 decimals, coordinates with 1): within one last digit and
# a half
SCORE_BOUND, BOX_BOUND = 1.5e-3, 0.15
MAP_BOUND = 1e-3
RANK_TIMEOUT_S = 900.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(cmd, n: int) -> str:
    """`cmd` as n ranks of a gloo group on the CPU (torchrun's environment
    over a free local port, tried twice) -> rank 0's output."""
    threads = str(max(1, (os.cpu_count() or 1) // n))
    for attempt in range(2):
        port = str(_free_port())
        procs = []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS=threads)
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return outs[0]
        text = "\n".join(o[-3000:] for o in outs)
        if attempt or "EADDRINUSE" not in text and "already in use" not in text:
            raise RuntimeError(f"{n} ranks of {' '.join(cmd)} failed:\n{text}")
    raise AssertionError("unreachable")


def _compare_files(path, want_path):
    """(identical, differing lines, largest score and coordinate moves) of
    a detection file against the single variant's; a line that differs in
    anything but its printed numbers counts as an infinite move."""
    with open(path) as f, open(want_path) as g:
        got, want = f.read().splitlines(), g.read().splitlines()
    if got == want:
        return True, [], 0.0, 0.0
    if len(got) != len(want):
        return False, [(a, b) for a, b in zip(got, want) if a != b], float("inf"), float("inf")
    differing, score, box = [], 0.0, 0.0
    for a, b in zip(got, want):
        if a == b:
            continue
        differing.append((a, b))
        x, y = a.split(), b.split()
        if x[0] != y[0]:
            return False, differing, float("inf"), float("inf")
        score = max(score, abs(float(x[1]) - float(y[1])))
        box = max(box, max(abs(float(u) - float(v)) for u, v in zip(x[2:], y[2:])))
    return False, differing, score, box


def cmd_consistency(args) -> bool:
    """Eval of the first `--n_consistency` test images on one device, one
    image at a time, as `--data_parallel 8` at batch 8 (a replica an image)
    and as `--spatial_partition 4` over four ranks, on the CPU -> whether
    every variant's detection files equal the single variant's (byte for
    byte, or within the bounds, each differing line printed) and its mAP
    equals it within MAP_BOUND."""
    voc_root, _, logs = _dirs(args)
    main_dir = os.path.join(voc_root, "ImageSets", "Main")
    with open(os.path.join(main_dir, "test.txt")) as f:
        ids = f.read().split()[: args.n_consistency]
    with open(os.path.join(main_dir, "consistency.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    maps, result_dirs = {}, {}
    for name, flags in CONSISTENCY_VARIANTS.items():
        rdir = os.path.join(args.root, f"consistency_{args.model_type}_{name}")
        if os.path.exists(rdir):
            shutil.rmtree(rdir)
        result_dirs[name] = rdir
        cmd = _module("eval_pascal") + [
            logs, "--root_path", voc_root, "--model_type", args.model_type,
            "--backbone", args.backbone, "--mode", "consistency", "--result_dir", rdir,
            "--device", "cpu", *flags]
        for ov in args.config_override:
            cmd += ["--config_override", ov]
        if name == "sp4":
            print("+ " + " ".join(cmd) + f"  (x{SPATIAL_RANKS} ranks)", flush=True)
            stdout = _run_ranks(cmd, SPATIAL_RANKS)
        else:
            stdout = _run(cmd, capture_output=True, text=True).stdout
        for line in stdout.splitlines():
            if line.strip().startswith("mAP"):
                maps[name] = float(line.split()[-1])
    variants = {}
    for name in CONSISTENCY_VARIANTS:
        if name == "single":
            continue
        identical, lines, score, box = True, 0, 0.0, 0.0
        for cls in PASCAL_CLASSES:
            same, differing, s_move, b_move = _compare_files(
                os.path.join(result_dirs[name], f"{cls}.txt"),
                os.path.join(result_dirs["single"], f"{cls}.txt"))
            identical &= same
            lines += len(differing)
            score, box = max(score, s_move), max(box, b_move)
            for got, want in differing:
                print(f"DIFFERS {name} {cls}.txt: {got!r} (single: {want!r})")
        map_gap = (abs(maps[name] - maps["single"]) if name in maps and "single" in maps
                   else float("inf"))
        variants[name] = {"files_identical": identical, "differing_lines": lines,
                          "max_score_move": score, "max_box_move": box, "map_gap": map_gap,
                          "consistent": score <= SCORE_BOUND and box <= BOX_BOUND
                          and map_gap <= MAP_BOUND}
    summary = {
        "proof": "rehearsal_consistency",
        "model_type": args.model_type,
        "n_images": len(ids),
        "mAP": maps,
        "bounds": {"score": SCORE_BOUND, "box_px": BOX_BOUND, "mAP": MAP_BOUND},
        "variants": variants,
        "files_identical": all(v["files_identical"] for v in variants.values()),
        "maps_equal": len(maps) == len(CONSISTENCY_VARIANTS) and len(set(maps.values())) == 1,
    }
    print("CONSISTENCY " + json.dumps(summary))
    return all(v["consistent"] for v in variants.values())


def _voc_to_coco_json(voc_root: str, split: str, out_path: str) -> int:
    """Write the split's VOC annotations as a COCO annotation file ->
    the number of annotations. Categories 1..20 in PASCAL_CLASSES order;
    bbox [x, y, w, h] from the 1-based VOC corners with the +1 width and
    height of `coco_eval.coco_results_for_image`; difficult -> iscrowd."""
    from tf_eager_object_detection_tpu_torch.data.voc import parse_voc_xml, read_image_set

    ids = read_image_set(os.path.join(voc_root, "ImageSets", "Main", split + ".txt"))
    images, annotations = [], []
    for image_id in ids:
        ann = parse_voc_xml(os.path.join(voc_root, "Annotations", f"{image_id}.xml"))
        images.append({"id": int(image_id), "file_name": f"{image_id}.jpg",
                       "height": ann["height"], "width": ann["width"]})
        for o in ann["objects"]:
            xmin, ymin, xmax, ymax = o["bbox"]
            w, h = xmax - xmin + 1.0, ymax - ymin + 1.0
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": int(image_id),
                "category_id": PASCAL_CLASSES.index(o["name"]) + 1,
                "bbox": [float(xmin - 1.0), float(ymin - 1.0), float(w), float(h)],
                "area": float(w * h),
                "iscrowd": int(o.get("difficult", 0)),
            })
    with open(out_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": i + 1, "name": c}
                                  for i, c in enumerate(PASCAL_CLASSES)]}, f)
    return len(annotations)


# the checkpoint is a Pascal model: its class count, anchor scales, pixel
# means and per-image caps go into the COCO config
COCO_EVAL_OVERRIDES = [
    "num_classes=21",
    "scales=[8, 16, 32]",
    "bgr_pixel_means=[103.939, 116.779, 123.68]",
    "max_objects_per_class_per_image=50",
    "max_objects_per_image=50",
]


def cmd_coco(args):
    """Score the trained checkpoint on the test split with the COCO
    evaluator through `eval_coco`."""
    from tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal import parse_stats

    voc_root, _, logs = _dirs(args)
    ann_file = os.path.join(args.root, "coco_test_annotations.json")
    n_ann = _voc_to_coco_json(voc_root, "test", ann_file)
    results_json = os.path.join(args.root,
                                f"coco_results_{args.model_type}_{args.backbone}.json")
    cmd = _module("eval_coco") + [
        logs, "--annotation_file", ann_file,
        "--image_dir", os.path.join(voc_root, "JPEGImages"),
        "--model_type", args.model_type, "--backbone", args.backbone,
        "--results_json", results_json,
        "--batch_size", str(args.eval_batch_size), "--device", args.device,
    ]
    for ov in COCO_EVAL_OVERRIDES + args.config_override:
        cmd += ["--config_override", ov]
    out = _run(cmd, capture_output=True, text=True)
    sys.stderr.write(out.stderr[-1000:])
    print(out.stdout[-2500:])
    summary = {
        "proof": "coco_rehearsal",
        "model_type": args.model_type,
        "backbone": args.backbone,
        "n_gt_annotations": n_ann,
        "metrics": parse_stats(out.stdout),
    }
    print("COCO_REHEARSAL " + json.dumps(summary))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=["gen", "train", "eval", "run", "coco", "consistency"])
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "voc_rehearsal"))
    p.add_argument("--n_train", type=int, default=600)
    p.add_argument("--n_test", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--lr", type=float, default=2.5e-4,
                   help="0 = use the config schedule (see --config_override)")
    p.add_argument("--config_override", action="append", default=[],
                   help="passed through to the train and eval command lines (for `coco`, "
                        "after its Pascal overrides)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--compute_dtype", default=None, choices=[None, "float32", "bfloat16"],
                   help="passed to the train command line (evaluation takes it as "
                        "--config_override tpu_compute_dtype=...)")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--n_consistency", type=int, default=8,
                   help="consistency: the number of test images to evaluate")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--resume", action="store_true",
                   help="keep the logs directory and continue from its latest checkpoint; "
                        "--steps then counts additional steps")
    args = p.parse_args(argv)

    if args.cmd == "consistency":
        return 0 if cmd_consistency(args) else 1
    if args.cmd == "gen":
        cmd_gen(args)
        return 0
    if args.cmd == "coco":
        cmd_coco(args)
        return 0
    if args.cmd == "train":
        cmd_train(args)
        return 0
    if args.cmd == "run":
        cmd_gen(args)
        cmd_train(args)
    summary = cmd_eval(args)
    return 0 if summary["mAP"] >= 0.85 else 1


if __name__ == "__main__":
    sys.exit(main())
