"""Training command line (port of `scripts/train.py`).

    python -m tf_eager_object_detection_tpu_torch.scripts.train --model_type faster_rcnn \
        --backbone resnet50 --data_type pascal --tf_records_dir /data/tfrecords \
        --logs_dir /tmp/logs --epochs 14
    python -m tf_eager_object_detection_tpu_torch.scripts.train --data_type coco \
        --coco_annotation_file instances_train.json --coco_image_dir train_images

Runs on the card unless `--device cpu` is given. `--compute_dtype bfloat16`
trains with bfloat16 compute (parameters, optimizer state and checkpoints
stay float32). `--backbone_weights` starts a fresh run from a pretrained
backbone: a keras-applications `.h5` path, an `https://` URL (optionally
`#md5=<hex>`), `keras` (the reference's release file for the backbone,
downloaded once into `~/.cache/tpu_od`) or a slim `vgg_16` TF checkpoint
prefix (VGG16); a restored checkpoint takes precedence over it.

Data parallelism, one process a GPU over `torch.distributed` (NCCL on the
card, gloo with `--device cpu`), the global batch being `--batch_size`
(per device) times the world size, every rank building the same batch
stream from `--seed` and training on its rows of each batch:

    torchrun --standalone --nproc_per_node=N \
        -m tf_eager_object_detection_tpu_torch.scripts.train --data_parallel ...
    python -m tf_eager_object_detection_tpu_torch.scripts.train --multihost \
        --coordinator_address HOST:PORT --num_processes P --process_id R ...

`--data_parallel` is one host, one process a local GPU, started by
torchrun (without torchrun's environment it trains as a group of one
process); `--multihost` joins over the coordinator flags (each process's
GPU is `cuda:$LOCAL_RANK`, 0 by default), or from torchrun's environment
(`torchrun --nnodes ...`). Only rank 0 logs and writes summaries; rank 0
writes the checkpoints.

Spatial partitioning, each image's rows sharded over N ranks
(`parallel/spatial.py`), the world size W a multiple of N, the global
batch `--batch_size` times W // N:

    torchrun --standalone --nproc_per_node=W \
        -m tf_eager_object_detection_tpu_torch.scripts.train --spatial_partition N ...

Without torchrun's environment, or where N does not divide W, it refuses
before joining; with `--multihost` it refuses, as JAX does.
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
    p.add_argument("--backbone_weights", default=None,
                   help="pretrained backbone for a fresh run: a keras .h5 path, an https URL "
                        "(optionally #md5=<hex>), 'keras', or a slim vgg_16 TF checkpoint "
                        "prefix; a restored checkpoint takes precedence")
    p.add_argument("--config_override", action="append", default=[], metavar="KEY=JSON",
                   help="override one config key (value parsed as JSON; repeatable)")
    p.add_argument("--data_parallel", action="store_true",
                   help="one process a local GPU over torch.distributed (start with torchrun "
                        "--standalone --nproc_per_node=N)")
    p.add_argument("--multihost", action="store_true",
                   help="data parallelism over several hosts (every process runs this command "
                        "line with the same flags; the global batch spans all processes)")
    p.add_argument("--coordinator_address", default=None,
                   help="with --multihost: host:port of process 0 (default: torchrun's "
                        "environment)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="with --multihost: the number of processes")
    p.add_argument("--process_id", type=int, default=None,
                   help="with --multihost: this process's rank")
    p.add_argument("--spatial_partition", type=int, default=1,
                   help="shard each image's rows over N ranks (start with torchrun "
                        "--standalone --nproc_per_node=W, W a multiple of N)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def _join(args) -> tuple:
    """(device, number of batch shares): join the process group where a
    data-parallel or spatial flag asks for it; the global batch is the
    per-device batch times the shares (the world size, or its batch groups
    under spatial partitioning). Every refusal comes before the group is
    joined."""
    coordinated = [args.coordinator_address, args.num_processes, args.process_id]
    if any(v is not None for v in coordinated) and not args.multihost:
        raise SystemExit("--coordinator_address, --num_processes and --process_id go with "
                         "--multihost")
    if args.spatial_partition > 1:
        if args.multihost:
            raise SystemExit("--spatial_partition with --multihost is not supported: spatial "
                             "partitioning targets one host with more GPUs than images")
        from tf_eager_object_detection_tpu_torch.parallel import multihost, spatial

        device = spatial.join(args.spatial_partition, args.device)
        return device, multihost.rank_and_world()[1] // args.spatial_partition
    if not (args.data_parallel or args.multihost):
        return args.device, 1
    if args.multihost and args.coordinator_address is None and "RANK" not in os.environ:
        raise SystemExit("--multihost needs --coordinator_address, --num_processes and "
                         "--process_id, or torchrun's environment")
    from tf_eager_object_detection_tpu_torch.parallel import multihost

    device = multihost.local_device(args.device)
    _, world = multihost.initialize(args.coordinator_address, args.num_processes,
                                    args.process_id, device=device)
    return device, world


def main(argv=None):
    args = parse_args(argv)
    device, shares = _join(args)
    try:
        return _train(args, device, shares)
    finally:
        if args.data_parallel or args.multihost or args.spatial_partition > 1:
            from tf_eager_object_detection_tpu_torch.parallel.multihost import shutdown

            shutdown()


def _train(args, device, shares):
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
    detector = model_factory(args.model_type, args.backbone, cfg, device=device, seed=args.seed)

    data_cfg = {
        "model_config": cfg,
        # the global batch; each rank trains on its rows
        "batch_size": cfg["tpu_train_batch_size_per_device"] * shares,
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
        backbone_weights=args.backbone_weights,
        data_parallel=args.data_parallel,
        multihost=args.multihost,
        spatial_partition=args.spatial_partition,
    )
    trainer.train(batches, args.epochs or cfg["epochs"], args.steps_per_epoch)


if __name__ == "__main__":
    main()
