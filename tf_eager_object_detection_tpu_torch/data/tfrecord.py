"""TFRecord files and the `tf.train.Example` wire format, in pure Python
(port of `tf_eager_object_detection_tpu/data/tfrecord.py`, without its
optional ctypes library `native/libtfrecord_io.so`).

The files are those the reference writes and reads, byte for byte.
A record:

    uint64 little-endian length
    uint32 masked crc32c(length bytes)
    byte   data[length]
    uint32 masked crc32c(data)

with mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32). The
crc32c comes from `google_crc32c` where it is installed, else from a
table. An Example:

    Example  { Features features = 1 }
    Features { map<string, Feature> feature = 1 }
    Feature  { oneof: BytesList = 1, FloatList = 2, Int64List = 3 }
    BytesList{ repeated bytes value = 1 }
    FloatList{ repeated float value = 1 [packed] }
    Int64List{ repeated int64 value = 1 [packed] }
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

try:
    import google_crc32c
except ImportError:  # pragma: no cover
    google_crc32c = None

__all__ = [
    "TFRecordWriter",
    "read_tfrecords",
    "encode_example",
    "decode_example",
]


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = None if google_crc32c is not None else _crc_table()


def _crc32c(data: bytes) -> int:
    if _CRC_TABLE is None:
        return google_crc32c.value(data)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    """Writes records to `path` (truncated); a context manager."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """The records of a TFRecord file, in order."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if check_crc and (_masked_crc(header) != hcrc or _masked_crc(data) != dcrc):
                raise IOError(f"corrupt tfrecord in {path}")
            yield data


# ------------------------------------------------------------ proto varint
def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_field(out: bytearray, field: int, body: bytes):
    """A length-delimited field."""
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(body))
    out += body


# ------------------------------------------------------- Example encoding
FeatureValue = Union[List[bytes], List[float], List[int]]


def _encode_feature(value: FeatureValue, kind: str) -> bytes:
    inner = bytearray()
    if kind == "bytes":
        for v in value:
            _write_field(inner, 1, v)
        field = 1
    elif kind == "float":
        _write_field(inner, 1, struct.pack(f"<{len(value)}f", *value))
        field = 2
    elif kind == "int64":
        packed = bytearray()
        for v in value:
            _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
        _write_field(inner, 1, bytes(packed))
        field = 3
    else:
        raise ValueError(kind)
    out = bytearray()
    _write_field(out, field, bytes(inner))
    return bytes(out)


def encode_example(features: Dict[str, tuple]) -> bytes:
    """features: name -> (kind, list) with kind in {bytes, float, int64}."""
    fmap = bytearray()
    for name, (kind, value) in features.items():
        entry = bytearray()
        _write_field(entry, 1, name.encode())
        _write_field(entry, 2, _encode_feature(value, kind))
        _write_field(fmap, 1, bytes(entry))
    out = bytearray()
    _write_field(out, 1, bytes(fmap))
    return bytes(out)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    elif wire == 1:
        pos += 8
    else:
        raise ValueError(f"bad wire type {wire}")
    return pos


def _decode_list(body: bytes, kind: str) -> list:
    out, p = [], 0
    while p < len(body):
        t, p = _read_varint(body, p)
        if kind == "bytes":
            ln, p = _read_varint(body, p)
            out.append(body[p : p + ln])
            p += ln
        elif kind == "float" and (t & 7) == 2:  # packed
            ln, p = _read_varint(body, p)
            out.extend(struct.unpack(f"<{ln // 4}f", body[p : p + ln]))
            p += ln
        elif kind == "float":  # unpacked fixed32
            out.append(struct.unpack("<f", body[p : p + 4])[0])
            p += 4
        elif (t & 7) == 2:  # int64, packed
            ln, p = _read_varint(body, p)
            end = p + ln
            while p < end:
                v, p = _read_varint(body, p)
                out.append(_signed(v))
        else:  # int64, unpacked
            v, p = _read_varint(body, p)
            out.append(_signed(v))
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_KINDS = {1: "bytes", 2: "float", 3: "int64"}


def _decode_feature(buf: bytes) -> tuple:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        n, pos = _read_varint(buf, pos)
        body = buf[pos : pos + n]
        pos += n
        kind = _KINDS.get(tag >> 3)
        if kind is not None:
            return kind, _decode_list(body, kind)
    return "bytes", []


def decode_example(buf: bytes) -> Dict[str, tuple]:
    """bytes -> {name: (kind, list)}."""
    out: Dict[str, tuple] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag != _tag(1, 2):
            pos = _skip_field(buf, pos, tag & 7)
            continue
        n, pos = _read_varint(buf, pos)
        fmap = buf[pos : pos + n]
        pos += n
        p = 0
        while p < len(fmap):
            t, p = _read_varint(fmap, p)
            if t != _tag(1, 2):
                p = _skip_field(fmap, p, t & 7)
                continue
            ln, p = _read_varint(fmap, p)
            entry = fmap[p : p + ln]
            p += ln
            ep, name, feat = 0, None, None
            while ep < len(entry):
                et, ep = _read_varint(entry, ep)
                eln, ep = _read_varint(entry, ep)
                body = entry[ep : ep + eln]
                ep += eln
                if (et >> 3) == 1:
                    name = body.decode()
                else:
                    feat = _decode_feature(body)
            if name is not None and feat is not None:
                out[name] = feat
    return out
