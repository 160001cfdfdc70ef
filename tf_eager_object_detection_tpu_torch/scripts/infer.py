"""Single-image inference command line (port of `scripts/infer.py`, the
reference's `test_one_image` flow): load -> preprocess -> predict -> print,
and draw the boxes.

    python -m tf_eager_object_detection_tpu_torch.scripts.infer CKPT image.jpg --out dets.png

CKPT is a checkpoint directory of the port's trainer, a params `.npz` in
the JAX package's format, or with `--use_tf_faster_rcnn_model`,
`--use_fpn_tensorflow_model` or `--keras_h5` a third-party checkpoint
(`ref_import/cli.py`). The image is read as JAX reads it: cv2, else PIL
(`models/detector.py::read_image_file`), so formats cv2 cannot decode
(TGA, PCX, ICO, ...) are read too; the overlay reads it with PIL. Runs on
the card unless `--device cpu` is given. Not ported yet:
`--spatial_partition` (ROADMAP item 8).
"""

import argparse

import numpy as np

from tf_eager_object_detection_tpu_torch.ref_import.cli import add_import_flags


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt", help="checkpoint dir or params .npz")
    p.add_argument("image")
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50",
                   choices=["vgg16", "resnet50", "resnet101", "resnet152"])
    p.add_argument("--data_type", default="pascal", choices=["pascal", "coco"])
    p.add_argument("--out", default=None, help="write the box-overlay image here")
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (JSON value; repeatable)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    add_import_flags(p)
    args = p.parse_args(argv)

    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )
    from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
    from tf_eager_object_detection_tpu_torch.ref_import.cli import load_checkpoint_params

    cfg = apply_config_overrides(dict(config_factory(args.data_type, args.model_type)),
                                 args.config_override)
    det = model_factory(args.model_type, args.backbone, cfg, device=args.device)
    image_format = load_checkpoint_params(det, args.ckpt, args)
    boxes, labels, scores = det.test_one_image(args.image, image_format=image_format)
    keep = scores >= args.score_threshold
    boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
    names = ({i + 1: n for i, n in enumerate(PASCAL_CLASSES)} if args.data_type == "pascal"
             else {})
    for b, lab, s in zip(boxes, labels, scores):
        name = names.get(int(lab), str(int(lab)))
        print(f"{name:>15s} {s:.3f}  [{b[0]:.1f}, {b[1]:.1f}, {b[2]:.1f}, {b[3]:.1f}]")
    if args.out:
        from PIL import Image

        from tf_eager_object_detection_tpu_torch.utils.visual import draw_bboxes_with_labels

        img = np.asarray(Image.open(args.image).convert("RGB"))
        tags = [f"{names.get(int(lab), int(lab))}:{s:.2f}" for lab, s in zip(labels, scores)]
        Image.fromarray(draw_bboxes_with_labels(img, boxes, tags)).save(args.out)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
