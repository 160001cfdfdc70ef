"""COCO evaluation command line (port of `scripts/eval_coco.py`).

Runs the detector over the images of a COCO annotation file, writes a
results JSON ([{image_id, category_id, bbox [x, y, w, h], score}]) in the
file's image order and prints the 12 COCO bbox stats of the port's own
evaluator (`evaluation/coco_eval.py`, no pycocotools).

    python -m tf_eager_object_detection_tpu_torch.scripts.eval_coco CKPT \
        --annotation_file instances_val.json --image_dir val_images

CKPT is a checkpoint directory of the port's trainer or a params `.npz` in
the JAX package's format. Runs on the card unless `--device cpu` is given.
`--data_parallel N` splits each batch of `--batch_size` images over
replicas of the detector on the first N GPUs (with `--device cpu`, N
replicas on the CPU).
"""

import argparse
import json

from tf_eager_object_detection_tpu_torch.ref_import.cli import add_import_flags


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt", help="checkpoint dir or params .npz")
    p.add_argument("--annotation_file", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--model_type", default="faster_rcnn", choices=["faster_rcnn", "fpn"])
    p.add_argument("--backbone", default="resnet50",
                   choices=["vgg16", "resnet50", "resnet101", "resnet152"])
    p.add_argument("--results_json", default="./coco_results.json")
    p.add_argument("--preprocessing_type", default="caffe", choices=["caffe", "tf"])
    p.add_argument("--batch_size", type=int, default=8,
                   help="bucket-grouped im_detect_batch size (1 = one image at a time)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over this many replicas (0 = one device)")
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (JSON value; repeatable)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    add_import_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the 12 stats."""
    args = parse_args(argv)
    from tf_eager_object_detection_tpu_torch.parallel.mesh import check_eval_data_parallel

    check_eval_data_parallel(args.batch_size, args.data_parallel, args.device)
    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )
    from tf_eager_object_detection_tpu_torch.data.coco import coco_eval_iterator
    from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
    from tf_eager_object_detection_tpu_torch.evaluation.coco_eval import (
        coco_results_for_image,
        evaluate_coco_detections,
    )
    from tf_eager_object_detection_tpu_torch.evaluation.pascal_eval_files import (
        eval_post_process,
    )
    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
    from tf_eager_object_detection_tpu_torch.ref_import.cli import load_checkpoint_params

    cfg = apply_config_overrides(dict(config_factory("coco", args.model_type)),
                                 args.config_override)
    detector = model_factory(args.model_type, args.backbone, cfg, device=args.device)
    image_format = load_checkpoint_params(detector, args.ckpt, args)
    iterator, ds = coco_eval_iterator(args.annotation_file, args.image_dir, cfg,
                                      args.preprocessing_type, image_format=image_format)
    # batches complete out of stream order: key the results by stream index
    per_index = {}
    for idx, item, (sm, deltas, rois, roi_valid) in batched_im_detect(
            detector, iterator, args.batch_size, args.data_parallel):
        boxes_c, scores_c, valid_c = (t.cpu().numpy() for t in eval_post_process(
            sm, deltas, rois, roi_valid, float(item[3]), float(item[4]),
            max_per_class=cfg["max_objects_per_class_per_image"],
            score_threshold=cfg["prediction_score_threshold"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            min_size=10.0,
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            clip_deltas=not cfg.get("strict_reference_parity", False),
        ))
        per_index[idx] = coco_results_for_image(boxes_c, scores_c, valid_c, item[5],
                                                ds.label_to_cat_id, cfg["max_objects_per_image"])
    results = [r for idx in sorted(per_index) for r in per_index[idx]]
    with open(args.results_json, "w") as f:
        json.dump(results, f)
    return evaluate_coco_detections(args.annotation_file, results)


if __name__ == "__main__":
    main()
