"""VOC XML -> sharded TFRecords (port of `scripts/generate_pascal_tf_records.py`).

    python -m tf_eager_object_detection_tpu_torch.scripts.generate_pascal_tf_records \
        --voc_root /data/VOCdevkit --year 2007 --mode trainval --output_dir /data/tfrecords
"""

import argparse

from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--voc_root", required=True, help=".../VOCdevkit")
    p.add_argument("--year", default="2007")
    p.add_argument("--mode", default="trainval")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_shards", type=int, default=5)
    args = p.parse_args(argv)
    for path in create_pascal_tf_records(args.voc_root, args.year, args.mode, args.output_dir,
                                         args.num_shards):
        print("wrote", path)


if __name__ == "__main__":
    main()
