"""Pascal VOC annotations and their TFRecords
(port of `tf_eager_object_detection_tpu/data/voc.py`).

Writes the Example schema the reference parses:

    image/height, image/width                int64[1]
    image/filename, image/encoded            bytes[1]
    image/object/bbox/{xmin,xmax,ymin,ymax}  float, VOC's 1-based pixel
                                             coordinates - 1, normalized by
                                             (dim - 1)
    image/object/class/label                 int64
    image/object/class/text                  bytes

sharded round-robin over N files `pascal_{year}_{mode}_%02d.tfrecords`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from tf_eager_object_detection_tpu_torch.data.label_map import pascal_label_map_dict
from tf_eager_object_detection_tpu_torch.data.tfrecord import TFRecordWriter, encode_example

__all__ = ["parse_voc_xml", "voc_example", "create_pascal_tf_records"]


def _int_field(obj, name: str) -> int:
    node = obj.find(name)
    return int(node.text or 0) if node is not None else 0


def parse_voc_xml(xml_path: str) -> dict:
    """VOC annotation XML -> {filename, height, width, objects: [{name,
    difficult, pose, truncated, bbox [x1, y1, x2, y2]}]}."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    objects = []
    for obj in root.findall("object"):
        bb = obj.find("bndbox")
        pose = obj.find("pose")
        objects.append({
            "name": obj.find("name").text,
            "difficult": _int_field(obj, "difficult"),
            "pose": pose.text if pose is not None else "",
            "truncated": _int_field(obj, "truncated"),
            "bbox": [float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")],
        })
    return {
        "filename": root.find("filename").text,
        "height": int(size.find("height").text),
        "width": int(size.find("width").text),
        "objects": objects,
    }


def voc_example(ann: dict, jpeg_bytes: bytes, label_map: Optional[Dict[str, int]] = None) -> bytes:
    """One annotation and its encoded JPEG -> a serialized Example."""
    label_map = label_map or pascal_label_map_dict()
    h, w = ann["height"], ann["width"]
    xmin, xmax, ymin, ymax, labels, texts = [], [], [], [], [], []
    for obj in ann["objects"]:
        x1, y1, x2, y2 = obj["bbox"]
        xmin.append((x1 - 1.0) / (w - 1.0))
        xmax.append((x2 - 1.0) / (w - 1.0))
        ymin.append((y1 - 1.0) / (h - 1.0))
        ymax.append((y2 - 1.0) / (h - 1.0))
        labels.append(label_map[obj["name"]])
        texts.append(obj["name"].encode())
    return encode_example({
        "image/height": ("int64", [h]),
        "image/width": ("int64", [w]),
        "image/filename": ("bytes", [ann["filename"].encode()]),
        "image/encoded": ("bytes", [jpeg_bytes]),
        "image/object/bbox/xmin": ("float", xmin),
        "image/object/bbox/xmax": ("float", xmax),
        "image/object/bbox/ymin": ("float", ymin),
        "image/object/bbox/ymax": ("float", ymax),
        "image/object/class/label": ("int64", labels),
        "image/object/class/text": ("bytes", texts),
    })


def read_image_set(path: str) -> List[str]:
    """The image ids of an `ImageSets/Main/*.txt` file (first column)."""
    with open(path) as f:
        return [line.strip().split()[0] for line in f if line.strip()]


def create_pascal_tf_records(
    voc_root: str,
    year: str,
    mode: str,
    output_dir: str,
    num_shards: int = 5,
    label_map: Optional[Dict[str, int]] = None,
) -> List[str]:
    """`voc_root`/VOC{year} -> sharded TFRecords in `output_dir`; returns their paths."""
    base = os.path.join(voc_root, f"VOC{year}")
    ids = read_image_set(os.path.join(base, "ImageSets", "Main", f"{mode}.txt"))
    os.makedirs(output_dir, exist_ok=True)
    paths = [os.path.join(output_dir, f"pascal_{year}_{mode}_{i:02d}.tfrecords")
             for i in range(num_shards)]
    writers = [TFRecordWriter(p) for p in paths]
    try:
        for idx, image_id in enumerate(ids):
            ann = parse_voc_xml(os.path.join(base, "Annotations", f"{image_id}.xml"))
            with open(os.path.join(base, "JPEGImages", f"{image_id}.jpg"), "rb") as f:
                jpeg = f.read()
            writers[idx % num_shards].write(voc_example(ann, jpeg, label_map))
    finally:
        for w in writers:
            w.close()
    return paths
