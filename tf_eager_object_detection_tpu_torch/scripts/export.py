"""Export a model to serving artifacts, one `torch.export` program per image
bucket (port of `scripts/export.py`).

    python -m tf_eager_object_detection_tpu_torch.scripts.export CKPT \
        --backbone resnet50 --out_dir ./export

CKPT is what the eval command lines take: a checkpoint directory of the
port's trainer, a params `.npz` in the JAX package's format, or with
`--use_tf_faster_rcnn_model`, `--use_fpn_tensorflow_model` or `--keras_h5`
a third-party checkpoint (`ref_import/cli.py`). The programs are traced and
run on `--device` (default: the card), the counterpart of the JAX
script's `--platforms`. `--check` reloads the artifact and runs one
inference on a zero image.
"""

import argparse

import numpy as np

from tf_eager_object_detection_tpu_torch.ref_import.cli import add_import_flags


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt", help="checkpoint dir or params .npz")
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50",
                   choices=["vgg16", "resnet50", "resnet101", "resnet152"])
    p.add_argument("--data_type", default="pascal", choices=["pascal", "coco"])
    p.add_argument("--out_dir", default="./export")
    p.add_argument("--device", default="cuda",
                   help="torch device the programs are traced for and run on (default: the card)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and run a smoke inference")
    p.add_argument("--no_bake_params", action="store_true",
                   help="export predict(params, image, hw) with the weights as call inputs: "
                        "small programs and one params.npz, instead of the weights in "
                        "every bucket's program")
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (JSON value; repeatable)")
    add_import_flags(p)
    args = p.parse_args(argv)

    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )
    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
    from tf_eager_object_detection_tpu_torch.ref_import.cli import load_checkpoint_params
    from tf_eager_object_detection_tpu_torch.serving.export import export_predict, load_predict

    cfg = apply_config_overrides(dict(config_factory(args.data_type, args.model_type)),
                                 args.config_override)
    detector = model_factory(args.model_type, args.backbone, cfg, device=args.device)
    load_checkpoint_params(detector, args.ckpt, args)
    out = export_predict(detector, args.out_dir, bake_params=not args.no_bake_params)
    print("exported to", out)

    if args.check:
        predict, meta = load_predict(out, device=args.device)
        h, w = meta["buckets"][0]
        det = predict(np.zeros((h, w, 3), np.float32), np.asarray([h, w], np.int32))
        n = int(det.valid.sum())
        print(f"smoke inference ok: {n} detections on a zero image (bucket {h}x{w})")


if __name__ == "__main__":
    main()
