"""Training metrics (port of `tf_eager_object_detection_tpu/training/metrics.py`).

A `MetricWriter` writes a JSONL log of scalar metrics and TensorBoard event
files in the TFRecord framing of `data/tfrecord.py`, with a minimal encoder
of the Event and Summary protos (no tensorboard package):

    Event:         wall_time = 1 double, step = 2 int64,
                   file_version = 3 string, summary = 5 message
    Summary.Value: tag = 1 string, simple_value = 2 float, image = 4 message
    Image:         height = 1, width = 2, colorspace = 3, encoded = 4 bytes
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Optional

from tf_eager_object_detection_tpu_torch.data.tfrecord import TFRecordWriter, _write_varint

__all__ = ["MetricWriter"]


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _field_double(out: bytearray, field: int, value: float):
    _write_varint(out, _tag(field, 1))
    out += struct.pack("<d", value)


def _field_float(out: bytearray, field: int, value: float):
    _write_varint(out, _tag(field, 5))
    out += struct.pack("<f", value)


def _field_varint(out: bytearray, field: int, value: int):
    _write_varint(out, _tag(field, 0))
    _write_varint(out, value & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(out: bytearray, field: int, value: bytes):
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(value))
    out += value


def _encode_scalar_summary(scalars: Dict[str, float]) -> bytes:
    summary = bytearray()
    for tag_name, value in scalars.items():
        v = bytearray()
        _field_bytes(v, 1, tag_name.encode())
        _field_float(v, 2, float(value))
        _field_bytes(summary, 1, bytes(v))
    return bytes(summary)


def _encode_image_summary(tag_name: str, h: int, w: int, png: bytes) -> bytes:
    img = bytearray()
    _field_varint(img, 1, h)
    _field_varint(img, 2, w)
    _field_varint(img, 3, 3)
    _field_bytes(img, 4, png)
    v = bytearray()
    _field_bytes(v, 1, tag_name.encode())
    _field_bytes(v, 4, bytes(img))
    summary = bytearray()
    _field_bytes(summary, 1, bytes(v))
    return bytes(summary)


def _encode_event(step: int, summary: Optional[bytes] = None,
                  file_version: Optional[str] = None) -> bytes:
    out = bytearray()
    _field_double(out, 1, time.time())
    _field_varint(out, 2, step)
    if file_version is not None:
        _field_bytes(out, 3, file_version.encode())
    if summary is not None:
        _field_bytes(out, 5, summary)
    return bytes(out)


class MetricWriter:
    """Scalars (and images) to `log_dir`: `{name}_metrics.jsonl` and an
    `events.out.tfevents.*` file. With no `log_dir` it writes nothing."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self._events = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")
            fname = (f"events.out.tfevents.{int(time.time())}."
                     f"{socket.gethostname()}.{os.getpid()}.0")
            self._events = TFRecordWriter(os.path.join(log_dir, fname))
            self._events.write(_encode_event(0, file_version="brain.Event:2"))

    def write_scalars(self, step: int, scalars: Dict[str, float]):
        scalars = {k: float(v) for k, v in scalars.items()}
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": int(step), "time": time.time(), **scalars})
                              + "\n")
            self._jsonl.flush()
        if self._events:
            self._events.write(_encode_event(int(step), _encode_scalar_summary(scalars)))

    def write_image(self, step: int, tag: str, image_uint8):
        """An RGB uint8 image as a PNG image summary; skipped where PIL,
        the PNG encoder, is not installed."""
        if not self._events:
            return
        try:
            from PIL import Image
        except ImportError:
            return
        import io

        buf = io.BytesIO()
        Image.fromarray(image_uint8).save(buf, format="PNG")
        self._events.write(_encode_event(int(step), _encode_image_summary(
            tag, image_uint8.shape[0], image_uint8.shape[1], buf.getvalue())))

    def flush(self):
        pass  # TFRecordWriter writes through

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._events:
            self._events.close()
