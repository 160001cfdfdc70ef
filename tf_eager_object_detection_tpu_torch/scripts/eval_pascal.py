"""Pascal VOC evaluation command line (port of `scripts/eval_pascal.py`).

Runs the detector over the eval set, writes per-class VOC detection files
and prints each class's AP and the mAP (detectron-style `voc_eval`).

    python -m tf_eager_object_detection_tpu_torch.scripts.eval_pascal CKPT \
        --root_path /data/VOCdevkit/VOC2007 --model_type faster_rcnn --backbone resnet50

CKPT is a checkpoint directory of the port's trainer or a params `.npz` in
the JAX package's format. Runs on the card unless `--device cpu` is given.
`--data_parallel N` splits each batch of `--batch_size` images over
replicas of the detector on the first N GPUs (with `--device cpu`, N
replicas on the CPU). `--spatial_partition N` (exclusive with it) shards
each image's rows over N ranks, one process a GPU
(`parallel/spatial.py`), and rank 0 writes the files and scores them:

    torchrun --standalone --nproc_per_node=N \
        -m tf_eager_object_detection_tpu_torch.scripts.eval_pascal CKPT --spatial_partition N ...

Without torchrun's environment, with a world size that N does not divide,
or with an image bucket whose height N does not divide, it refuses before
joining (and `batched_im_detect` refuses a world size other than N).
"""

import argparse
import glob
import os

from tf_eager_object_detection_tpu_torch.ref_import.cli import add_import_flags


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt", nargs="?", default=None,
                   help="checkpoint dir or params .npz; optional with --use_local_result_files")
    p.add_argument("--root_path", required=True, help=".../VOCdevkit/VOC2007")
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50",
                   choices=["vgg16", "resnet50", "resnet101", "resnet152"])
    p.add_argument("--mode", default="test")
    p.add_argument("--result_dir", default="./voc_results")
    # VOC07's 11-point metric by default, as the reference
    p.add_argument("--use_07_metric", action="store_true", default=True)
    p.add_argument("--no_07_metric", dest="use_07_metric", action="store_false")
    p.add_argument("--preprocessing_type", default="caffe", choices=["caffe", "tf"])
    p.add_argument("--dataset_type", default="cv2", choices=["cv2", "tf"],
                   help="cv2: the JPEGs of the VOC tree; tf: eval TFRecords")
    p.add_argument("--tf_records_glob", default=None,
                   help="with --dataset_type tf: glob of eval TFRecords")
    p.add_argument("--use_local_result_files", action="store_true",
                   help="score the result files already in --result_dir, run no model")
    p.add_argument("--batch_size", type=int, default=8,
                   help="bucket-grouped im_detect_batch size (1 = one image at a time)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over this many replicas (0 = one device)")
    p.add_argument("--spatial_partition", type=int, default=0,
                   help="shard each image's rows over N ranks (start with torchrun "
                        "--standalone --nproc_per_node=N; exclusive with --data_parallel)")
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (JSON value; repeatable)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    add_import_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )
    from tf_eager_object_detection_tpu_torch.parallel.mesh import check_eval_data_parallel

    check_eval_data_parallel(args.batch_size, args.data_parallel, args.device)
    cfg = apply_config_overrides(dict(config_factory("pascal", args.model_type)),
                                 args.config_override)
    spatial = args.spatial_partition > 1 and not args.use_local_result_files
    if not spatial:
        return _evaluate(args, cfg, args.device)
    from tf_eager_object_detection_tpu_torch.parallel import multihost
    from tf_eager_object_detection_tpu_torch.parallel.spatial import join

    n = args.spatial_partition
    if args.data_parallel:
        raise ValueError("--data_parallel and --spatial_partition are exclusive")
    heights = [h for h, _ in cfg["tpu_image_buckets"] if h % n]
    if heights:
        raise ValueError(f"image bucket heights {heights} not divisible by spatial_partition={n}")
    device = join(n, args.device)
    try:
        return _evaluate(args, cfg, device)
    finally:
        multihost.shutdown()


def _evaluate(args, cfg, device):
    """Detections (unless --use_local_result_files), then, on rank 0 of a
    spatial run and always otherwise, the per-class APs and the mAP."""
    from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
    from tf_eager_object_detection_tpu_torch.evaluation.voc_eval import voc_eval
    from tf_eager_object_detection_tpu_torch.parallel.multihost import is_primary

    os.makedirs(args.result_dir, exist_ok=True)
    result_fmt = os.path.join(args.result_dir, "{:s}.txt")

    if not args.use_local_result_files:
        if not args.ckpt:
            raise SystemExit("a checkpoint is required unless --use_local_result_files is set")
        from tf_eager_object_detection_tpu_torch.data.pascal import (
            pascal_eval_iterator,
            pascal_eval_iterator_from_tf_records,
        )
        from tf_eager_object_detection_tpu_torch.evaluation.pascal_eval_files import (
            get_prediction_files,
        )
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        from tf_eager_object_detection_tpu_torch.ref_import.cli import load_checkpoint_params

        detector = model_factory(args.model_type, args.backbone, cfg, device=device)
        image_format = load_checkpoint_params(detector, args.ckpt, args)
        if args.dataset_type == "tf":
            if not args.tf_records_glob:
                raise SystemExit("--dataset_type tf requires --tf_records_glob")
            records = sorted(glob.glob(args.tf_records_glob))
            if not records:
                raise FileNotFoundError(args.tf_records_glob)
            iterator, image_ids = pascal_eval_iterator_from_tf_records(
                records, cfg, args.preprocessing_type, image_format=image_format)
        else:
            iterator, image_ids = pascal_eval_iterator(
                args.root_path, args.mode, cfg, args.preprocessing_type,
                image_format=image_format)
        get_prediction_files(
            detector, iterator, image_ids, result_fmt,
            score_threshold=cfg["prediction_score_threshold"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            max_objects_per_class=cfg["max_objects_per_class_per_image"],
            max_objects_per_image=cfg["max_objects_per_image"],
            batch_size=args.batch_size,
            data_parallel=args.data_parallel,
            spatial_partition=args.spatial_partition,
        )
    if not is_primary():
        return None

    annopath = os.path.join(args.root_path, "Annotations", "{:s}.xml")
    imageset = os.path.join(args.root_path, "ImageSets", "Main", f"{args.mode}.txt")
    cachedir = os.path.join(args.result_dir, "annotations_cache")
    aps = []
    for cls in PASCAL_CLASSES:
        _, _, ap = voc_eval(result_fmt, annopath, imageset, cls, cachedir,
                            ovthresh=cfg["evaluate_iou_threshold"],
                            use_07_metric=args.use_07_metric)
        aps.append(ap)
        print(f"{cls:>15s} AP = {ap:.4f}")
    print(f"{'mAP':>15s} = {sum(aps) / len(aps):.4f}")
    return aps


if __name__ == "__main__":
    main()
