"""Training command line (port of `scripts/train.py`).

    python -m tf_eager_object_detection_tpu_torch.scripts.train --model_type faster_rcnn \
        --backbone resnet50 --data_type pascal --tf_records_dir /data/tfrecords \
        --logs_dir /tmp/logs --epochs 14
    python -m tf_eager_object_detection_tpu_torch.scripts.train --data_type coco \
        --coco_annotation_file instances_train.json --coco_image_dir train_images

Runs on the card unless `--device cpu` is given. `--compute_dtype bfloat16`
trains with bfloat16 compute (parameters, momentum and checkpoints stay
float32). Not ported yet: `--data_parallel`, `--multihost` and
`--spatial_partition` (ROADMAP item 8), `--backbone_weights` (item 9).
"""

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50",
                   choices=["vgg16", "resnet50", "resnet101", "resnet152"])
    p.add_argument("--data_type", default="pascal", choices=["pascal", "coco"])
    p.add_argument("--tf_records_dir", default=None,
                   help="directory holding the *train*.tfrecords shards")
    p.add_argument("--coco_annotation_file", default=None,
                   help="with --data_type coco: the instances JSON")
    p.add_argument("--coco_image_dir", default=None,
                   help="with --data_type coco: the directory of its images")
    p.add_argument("--logs_dir", default="./logs")
    p.add_argument("--restore_ckpt_path", default=None,
                   help="checkpoint directory to start from (default: the latest in --logs_dir)")
    p.add_argument("--batch_size", type=int, default=None, help="batch (default: config)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=5000)
    p.add_argument("--logging_every_n_steps", type=int, default=100)
    p.add_argument("--summary_every_n_steps", type=int, default=100)
    p.add_argument("--saving_every_n_steps", type=int, default=5000)
    p.add_argument("--preprocessing_type", default="caffe", choices=["caffe", "tf"])
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                   help="override the config's tpu_compute_dtype")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="override the initial learning rate (later ones scale with it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (value parsed as JSON; repeatable)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )
    from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
    from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

    cfg = apply_config_overrides(dict(config_factory(args.data_type, args.model_type)),
                                 args.config_override)
    if args.batch_size:
        cfg["tpu_train_batch_size_per_device"] = args.batch_size
    if args.compute_dtype:
        cfg["tpu_compute_dtype"] = args.compute_dtype
    if args.learning_rate:
        lrs = cfg["learning_rate_multi_lrs"]
        scale = args.learning_rate / lrs[0]
        cfg["learning_rate_multi_lrs"] = [lr * scale for lr in lrs]
    detector = model_factory(args.model_type, args.backbone, cfg, device=args.device,
                             seed=args.seed)

    data_cfg = {
        "model_config": cfg,
        "batch_size": cfg["tpu_train_batch_size_per_device"],
        "preprocessing_type": args.preprocessing_type,
        "seed": args.seed,
    }
    if args.data_type == "pascal":
        records = sorted(glob.glob(os.path.join(args.tf_records_dir or ".",
                                                "*train*.tfrecords")))
        if not records:
            raise FileNotFoundError(f"no *train*.tfrecords under {args.tf_records_dir}")
        data_cfg["tf_records_list"] = records
    else:
        data_cfg["annotation_file"] = args.coco_annotation_file
        data_cfg["image_dir"] = args.coco_image_dir
    batches = dataset_factory(args.data_type, "train", data_cfg)
    trainer = Trainer(
        detector,
        train_dir=args.logs_dir,
        logging_every_n_steps=args.logging_every_n_steps,
        summary_every_n_steps=args.summary_every_n_steps,
        saving_every_n_steps=args.saving_every_n_steps,
        restore_ckpt_path=args.restore_ckpt_path,
        seed=args.seed,
    )
    trainer.train(batches, args.epochs or cfg["epochs"], args.steps_per_epoch)


if __name__ == "__main__":
    main()
