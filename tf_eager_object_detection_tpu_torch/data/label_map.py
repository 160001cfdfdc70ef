"""Label maps (port of `tf_eager_object_detection_tpu/data/label_map.py`).

The pbtxt text format of a `StringIntLabelMap` holds only
`item { id: N name: '...' }` entries, so it is parsed directly, without
protoc. Id 0 is reserved for the background; the VOC map has ids 1..20.
"""

from __future__ import annotations

import re
from typing import Dict, List

__all__ = [
    "parse_label_map",
    "get_label_map_dict",
    "pascal_label_map_dict",
    "PASCAL_CLASSES",
]

PASCAL_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

_ITEM_RE = re.compile(r"item\s*\{([^}]*)\}", re.S)
_FIELD_RE = re.compile(r"(\w+)\s*:\s*('[^']*'|\"[^\"]*\"|\S+)")


def parse_label_map(text: str) -> List[dict]:
    """pbtxt text -> one dict per `item { ... }`: quoted values as strings,
    integers as ints, anything else as its text."""
    items = []
    for block in _ITEM_RE.finditer(text):
        item: dict = {}
        for m in _FIELD_RE.finditer(block.group(1)):
            key, val = m.group(1), m.group(2)
            if val[0] in "'\"":
                item[key] = val[1:-1]
            else:
                try:
                    item[key] = int(val)
                except ValueError:
                    item[key] = val
        if item:
            items.append(item)
    return items


def get_label_map_dict(path_or_text: str, use_display_name: bool = False) -> Dict[str, int]:
    """name -> id. Accepts a file path or raw pbtxt text."""
    try:
        with open(path_or_text) as f:
            text = f.read()
    except (OSError, ValueError):
        text = path_or_text
    out = {}
    for item in parse_label_map(text):
        if item.get("id", -1) < 0:
            raise ValueError("label map ids must be >= 0")
        out[item.get("display_name" if use_display_name else "name")] = item["id"]
    return out


def pascal_label_map_dict() -> Dict[str, int]:
    """The 20-class VOC label map (ids 1..20, background 0)."""
    return {name: i + 1 for i, name in enumerate(PASCAL_CLASSES)}
