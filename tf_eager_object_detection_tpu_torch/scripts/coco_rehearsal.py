"""80-class COCO rehearsal of the port: train and evaluate through the
port's COCO command lines to the 12 COCO stats (port of
`scripts/coco_rehearsal.py`).

No COCO data is needed: `gen` draws a procedural COCO-format set (1000
train / 200 val images at 600x800) over COCO's own category ids (1..90
with its 10 gaps), 3-7 objects an image, small `iscrowd` objects, and
unlabeled gray distractors; each class a saturated color (10) times a
texture (4) times a texture period (14 or 34 px). The draws, the JSON and
the cv2 JPEGs (quality 92) are those of the JAX script for a seed. The
stock COCO config (anchor scales 4, 8, 16, 32; 81 classes; caps of 100)
trains on it from random weights through `train --data_type coco`, with
a from-scratch learning rate (2.5e-4, then 5e-5 from half the steps);
`eval_coco` scores it.

    python -m tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal gen   --root DIR
    python -m tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal train --steps 16000
    python -m tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal eval
    python -m tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal run   # all three

`eval` prints `COCO80_REHEARSAL {json}` with the stats and the number of
categories with at least one detection. Training is one
process (the JAX script's `--chunks` worked around a leak of its TPU
runtime).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import IMG_H, IMG_W, _place_box

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_PKG = "tf_eager_object_detection_tpu_torch.scripts"

# the COCO 2014 / 2017 detection category ids: 1..90 without these 10
_MISSING_COCO_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
COCO_CAT_IDS = [i for i in range(1, 91) if i not in _MISSING_COCO_IDS]

BASE_COLORS_10 = (
    (205, 40, 40),
    (40, 190, 40),
    (50, 70, 220),
    (230, 200, 40),
    (200, 50, 200),
    (40, 200, 200),
    (240, 130, 30),
    (130, 240, 130),
    (150, 110, 250),
    (250, 150, 150),
)


def class_patch80(ci: int, h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """Textured uint8 [h, w, 3] patch of class index ci (0..79): color ci %
    10, texture (ci // 10) % 4, period 14 px below index 40, else 34 px."""
    base = np.array(BASE_COLORS_10[ci % 10], np.float32)
    second = base * 0.3
    period = 14 if ci < 40 else 34
    pattern = (ci // 10) % 4  # 0 solid / 1 horizontal stripes / 2 vertical stripes / 3 checker
    jit = rng.uniform(0.8, 1.15)
    yy, xx = np.mgrid[0:h, 0:w]
    if pattern == 0:
        mask = np.ones((h, w), bool)
    elif pattern == 1:
        mask = (yy // period) % 2 == 0
    elif pattern == 2:
        mask = (xx // period) % 2 == 0
    else:
        mask = ((yy // period) + (xx // period)) % 2 == 0
    patch = np.where(mask[..., None], base, second) * jit
    patch += rng.normal(0.0, 6.0, patch.shape)
    return np.clip(patch, 0, 255).astype(np.uint8)


def draw_image80(rng: np.random.RandomState):
    """-> (uint8 [600, 800, 3], [(class index, x, y, w, h, iscrowd)])."""
    img = rng.randint(0, 55, (IMG_H, IMG_W, 3)).astype(np.uint8)
    for _ in range(rng.randint(3, 7)):  # unlabeled gray distractors
        g = rng.randint(70, 160)
        col = np.clip(np.array([g, g, g]) + rng.randint(-18, 18, 3), 0, 255).astype(np.uint8)
        dw, dh = rng.randint(40, 200), rng.randint(40, 200)
        dx, dy = rng.randint(0, IMG_W - dw), rng.randint(0, IMG_H - dh)
        img[dy : dy + dh, dx : dx + dw] = col

    objs, placed = [], []
    n_normal = rng.randint(3, 8)
    # small crowd objects: left out of training, ignored by the evaluator
    n_crowd = int(rng.uniform() < 0.5) + int(rng.uniform() < 0.2)
    specs = [(0, 110.0, 420.0)] * n_normal + [(1, 48.0, 90.0)] * n_crowd
    rng.shuffle(specs)
    for iscrowd, smin, smax in specs:
        box = _place_box(rng, placed, smin, smax)
        if box is None:
            continue
        placed.append(box)
        ci = rng.randint(0, 80)
        x1, y1, x2, y2 = box
        x2, y2 = min(x2, IMG_W - 1.0), min(y2, IMG_H - 1.0)
        objs.append((ci, x1, y1, x2 - x1, y2 - y1, iscrowd))
    # large before small: no small object is buried
    for ci, x, y, w, h, _ic in sorted(objs, key=lambda o: o[3] * o[4], reverse=True):
        x1, y1 = int(round(x)), int(round(y))
        x2, y2 = int(round(x + w)), int(round(y + h))
        img[y1:y2, x1:x2] = class_patch80(ci, y2 - y1, x2 - x1, rng)
    return img, objs


def generate(root: str, n_train: int, n_val: int, seed: int = 0):
    """Write `images/`, `instances_train.json` and `instances_val.json`;
    returns the val split's non-crowd object count per category id."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    splits = {"train": ([], []), "val": ([], [])}  # (images, annotations)
    class_counts = np.zeros(80, np.int64)
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        images, annotations = splits[split]
        img, objs = draw_image80(rng)
        fname = f"{i:06d}.jpg"
        cv2.imwrite(os.path.join(img_dir, fname), img[:, :, ::-1],  # RGB -> BGR for cv2
                    [int(cv2.IMWRITE_JPEG_QUALITY), 92])
        images.append({"id": i + 1, "file_name": fname, "height": IMG_H, "width": IMG_W})
        for ci, x, y, w, h, iscrowd in objs:
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": i + 1,
                "category_id": COCO_CAT_IDS[ci],
                "bbox": [round(x, 2), round(y, 2), round(w, 2), round(h, 2)],
                "area": round(w * h, 2),
                "iscrowd": iscrowd,
            })
            if split == "val" and not iscrowd:
                class_counts[ci] += 1
    categories = [{"id": cid, "name": f"class_{cid:02d}"} for cid in COCO_CAT_IDS]
    for split, (images, annotations) in splits.items():
        with open(os.path.join(root, f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)
    if n_val >= 100 and class_counts.min() == 0:  # smaller sets cannot cover 80 classes
        raise ValueError(f"val split missing classes: {np.where(class_counts == 0)[0]}")
    return {int(c): int(n) for c, n in zip(COCO_CAT_IDS, class_counts)}


def _run(cmd, **kw):
    print("+ " + " ".join(cmd), flush=True)
    return subprocess.run(cmd, check=True, cwd=REPO, **kw)


def _module(name: str):
    return [sys.executable, "-m", f"{_PKG}.{name}"]


def _dirs(args):
    return (os.path.join(args.root, "images"),
            os.path.join(args.root, "instances_train.json"),
            os.path.join(args.root, "instances_val.json"),
            os.path.join(args.root, f"logs_{args.model_type}_{args.backbone}"))


def parse_stats(stdout: str) -> dict:
    """The `AP ... = x` / `AR ... = x` lines of `CocoBboxEval.summarize` ->
    {name: value}."""
    metrics = {}
    for line in stdout.splitlines():
        s = line.strip()
        if (s.startswith("AP ") or s.startswith("AR ")) and " = " in s:
            key, val = s.rsplit(" = ", 1)
            try:
                metrics[" ".join(key.split())] = float(val)
            except ValueError:
                pass
    return metrics


def cmd_gen(args):
    counts = generate(args.root, args.n_train, args.n_val, args.seed)
    print(json.dumps({"gen": "ok", "val_instances_min": min(counts.values()),
                      "val_instances_total": sum(counts.values())}))


def cmd_train(args):
    img_dir, train_json, _, logs = _dirs(args)
    if os.path.exists(logs) and not args.resume:
        shutil.rmtree(logs)
    cmd = _module("train") + [
        "--model_type", args.model_type, "--backbone", args.backbone,
        "--data_type", "coco", "--coco_annotation_file", train_json,
        "--coco_image_dir", img_dir,
        "--logs_dir", logs, "--epochs", "1",
        "--steps_per_epoch", str(args.steps),
        "--logging_every_n_steps", "200",
        "--summary_every_n_steps", str(max(args.steps // 2, 1)),
        "--saving_every_n_steps", str(args.steps),
        "--batch_size", str(args.batch_size),
        # the from-scratch schedule (the stock 1e-3 from ImageNet weights
        # diverges from random weights), as the VOC rehearsal's
        "--config_override", f"learning_rate_multi_decay_steps=[{args.steps // 2}]",
        "--config_override", "learning_rate_multi_lrs=[0.00025,5e-05]",
        "--seed", str(args.seed),
        "--device", args.device,
    ]
    for ov in args.config_override:
        cmd += ["--config_override", ov]
    if args.compute_dtype:
        cmd += ["--compute_dtype", args.compute_dtype]
    _run(cmd)


def cmd_eval(args):
    img_dir, _, val_json, logs = _dirs(args)
    results_json = os.path.join(args.root, f"results_{args.model_type}_{args.backbone}.json")
    cmd = _module("eval_coco") + [
        logs, "--annotation_file", val_json, "--image_dir", img_dir,
        "--model_type", args.model_type, "--backbone", args.backbone,
        "--results_json", results_json,
        "--batch_size", str(args.eval_batch_size), "--device", args.device,
    ]
    for ov in args.config_override:
        cmd += ["--config_override", ov]
    out = _run(cmd, capture_output=True, text=True)
    sys.stderr.write(out.stderr[-1500:])
    print(out.stdout[-2500:])
    with open(results_json) as f:
        detected = {r["category_id"] for r in json.load(f)}
    summary = {
        "proof": "coco80_rehearsal",
        "model_type": args.model_type,
        "backbone": args.backbone,
        "metrics": parse_stats(out.stdout),
        "categories_detected": len(detected),
    }
    print("COCO80_REHEARSAL " + json.dumps(summary))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=["gen", "train", "eval", "run"])
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "coco_rehearsal"))
    p.add_argument("--n_train", type=int, default=1000)
    p.add_argument("--n_val", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--steps", type=int, default=16000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--compute_dtype", default=None, choices=[None, "float32", "bfloat16"],
                   help="passed to the train command line (evaluation takes it as "
                        "--config_override tpu_compute_dtype=...)")
    p.add_argument("--config_override", action="append", default=[],
                   help="passed through to the train and eval command lines, after the "
                        "learning-rate overrides")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--resume", action="store_true",
                   help="keep the logs directory and continue from its latest checkpoint; "
                        "--steps then counts additional steps")
    args = p.parse_args(argv)

    if args.cmd in ("gen", "run"):
        cmd_gen(args)
    if args.cmd in ("train", "run"):
        cmd_train(args)
    if args.cmd in ("eval", "run"):
        cmd_eval(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
